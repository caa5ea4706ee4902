"""Host-side data code (NumPy; cv2 imported where it is used): the affine
math and normalization of the inference path, COCO masks, the COCO dataset's
eval side, directory and video datasets. The training augmentations, targets
and loader come with training (ROADMAP module 10)."""

from .affine import (
    affine_transform_point,
    get_affine_transform,
    get_multi_scale_size,
    resize_align_multi_scale,
    transform_coords_inverse,
)
from .base import BaseImageDataset, DirectoryDataset, ExplorerDataset, InferenceDataset
from .coco import (
    COCO_LABELS,
    COCO_LIMBS,
    CocoKeypointsDataset,
    collate,
    get_coco_joints,
    prebake_annotations,
)
from .rle import get_crowd_mask, polygons_to_mask, segmentation_to_mask
from .transforms import COCO_FLIP_INDEX, inverse_normalize, normalize
from .video import InferenceVideoDataset, VideoProcessingResult

__all__ = [
    "BaseImageDataset",
    "COCO_FLIP_INDEX",
    "COCO_LABELS",
    "COCO_LIMBS",
    "CocoKeypointsDataset",
    "DirectoryDataset",
    "ExplorerDataset",
    "InferenceDataset",
    "InferenceVideoDataset",
    "VideoProcessingResult",
    "affine_transform_point",
    "collate",
    "get_affine_transform",
    "get_coco_joints",
    "get_crowd_mask",
    "get_multi_scale_size",
    "inverse_normalize",
    "normalize",
    "polygons_to_mask",
    "prebake_annotations",
    "resize_align_multi_scale",
    "segmentation_to_mask",
    "transform_coords_inverse",
]
