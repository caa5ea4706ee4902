"""Inference: the keypoints model (flip and multi-scale TTA, 64-aligned
resize, the AE decode on the device), the classification model (center
crop, softmax on the device), their result objects and plots, and the
batched COCO evaluator. Serving and the SPPE model come later."""

from .batched_eval import BatchedKeypointsEvaluator, evaluate_dataset_batched, image_id_from_path
from .models import InferenceClassificationModel, InferenceKeypointsModel, load_inference_weights
from .results import ClassificationResult, InferenceKeypointsResult, KeypointsResult
from .visualization import plot_connections, plot_grouped_ae_tags, plot_heatmaps, plot_top_probs

__all__ = [
    "BatchedKeypointsEvaluator",
    "ClassificationResult",
    "InferenceClassificationModel",
    "InferenceKeypointsModel",
    "InferenceKeypointsResult",
    "KeypointsResult",
    "evaluate_dataset_batched",
    "image_id_from_path",
    "load_inference_weights",
    "plot_connections",
    "plot_grouped_ae_tags",
    "plot_heatmaps",
    "plot_top_probs",
]
