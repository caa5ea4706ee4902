"""Inference: the keypoints model (flip and multi-scale TTA, 64-aligned
resize, the AE decode on the device), the single-person (SPPE) model (the
argmax decode on the device), the classification model (center crop,
softmax on the device), their result objects and plots, the batched COCO
evaluator and the dynamic-batching server (``serving``)."""

from .batched_eval import BatchedKeypointsEvaluator, evaluate_dataset_batched, image_id_from_path
from .models import (
    InferenceClassificationModel, InferenceKeypointsModel, InferenceSPPEModel, load_inference_weights,
)
from .results import ClassificationResult, InferenceKeypointsResult, KeypointsResult
from .serving import (
    BatchedClassificationPredictor, BatchedKeypointsPredictor, DynamicBatcher, PreparedClassRequest,
    PreparedRequest, decode_request_body, make_server,
)
from .visualization import plot_connections, plot_grouped_ae_tags, plot_heatmaps, plot_top_probs

__all__ = [
    "BatchedClassificationPredictor",
    "BatchedKeypointsEvaluator",
    "BatchedKeypointsPredictor",
    "ClassificationResult",
    "DynamicBatcher",
    "InferenceClassificationModel",
    "InferenceKeypointsModel",
    "InferenceKeypointsResult",
    "InferenceSPPEModel",
    "KeypointsResult",
    "PreparedClassRequest",
    "PreparedRequest",
    "decode_request_body",
    "evaluate_dataset_batched",
    "image_id_from_path",
    "load_inference_weights",
    "make_server",
    "plot_connections",
    "plot_grouped_ae_tags",
    "plot_heatmaps",
    "plot_top_probs",
]
