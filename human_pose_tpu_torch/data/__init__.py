"""Host-side data code (NumPy; cv2 imported where it is used): the affine
math, normalization and the keypoints training augmentations, the heatmap
and joints targets (with the native splat), COCO masks, the COCO dataset
with its mosaic and ``collate``, the loader, directory and video datasets."""

from .affine import (
    affine_transform_point,
    get_affine_transform,
    get_aug_affine_matrix,
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
from .loader import DataLoader
from .rle import get_crowd_mask, polygons_to_mask, segmentation_to_mask
from .targets import HeatmapGenerator, JointsGenerator
from .transforms import (
    COCO_FLIP_INDEX,
    ComposeKeypointsTransform,
    KeypointsTransform,
    NormalizeKeypoints,
    RandomAffineTransform,
    RandomHorizontalFlip,
    inverse_normalize,
    normalize,
)
from .video import InferenceVideoDataset, VideoProcessingResult

__all__ = [
    "BaseImageDataset",
    "COCO_FLIP_INDEX",
    "COCO_LABELS",
    "COCO_LIMBS",
    "CocoKeypointsDataset",
    "ComposeKeypointsTransform",
    "DataLoader",
    "DirectoryDataset",
    "ExplorerDataset",
    "HeatmapGenerator",
    "InferenceDataset",
    "InferenceVideoDataset",
    "JointsGenerator",
    "KeypointsTransform",
    "NormalizeKeypoints",
    "RandomAffineTransform",
    "RandomHorizontalFlip",
    "VideoProcessingResult",
    "affine_transform_point",
    "collate",
    "get_affine_transform",
    "get_aug_affine_matrix",
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
