"""Inference: the keypoints model (flip and multi-scale TTA, 64-aligned
resize, the AE decode on the device), its result objects and plots, and the
batched COCO evaluator. Serving, the SPPE and the classification models come
later."""

from .batched_eval import BatchedKeypointsEvaluator, evaluate_dataset_batched, image_id_from_path
from .models import InferenceKeypointsModel, load_inference_weights
from .results import InferenceKeypointsResult, KeypointsResult
from .visualization import plot_connections, plot_grouped_ae_tags, plot_heatmaps, plot_top_probs

__all__ = [
    "BatchedKeypointsEvaluator",
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
