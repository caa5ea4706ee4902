"""Host-side data code (NumPy; cv2 imported where it is used): the affine
math, normalization, the keypoints training augmentations and the
classification crops, the heatmap and joints targets (with the native
splat), COCO masks, the COCO dataset with its mosaic and ``collate``, the
COCO person crops of the top-down nets and ``collate_topdown``, the
ImageNet dataset and ``collate_classification``, the MPII reader and joint
layout, the loader, directory and video datasets."""

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
from .coco_topdown import CocoTopDownDataset, collate_topdown
from .imagenet import ImagenetClassificationDataset, collate_classification
from .loader import DataLoader
from .mpii import MPII_FLIP_INDEX, MPII_LABELS, MPII_LIMBS, MpiiKeypointsDataset
from .rle import get_crowd_mask, polygons_to_mask, segmentation_to_mask
from .targets import HeatmapGenerator, JointsGenerator
from .transforms import (
    COCO_FLIP_INDEX,
    ClassificationTransform,
    ComposeKeypointsTransform,
    KeypointsTransform,
    NormalizeKeypoints,
    RandomAffineTransform,
    RandomHorizontalFlip,
    center_crop,
    inverse_normalize,
    normalize,
    random_resized_crop,
    resize_short,
)
from .video import InferenceVideoDataset, VideoProcessingResult

__all__ = [
    "BaseImageDataset",
    "COCO_FLIP_INDEX",
    "COCO_LABELS",
    "COCO_LIMBS",
    "ClassificationTransform",
    "CocoKeypointsDataset",
    "CocoTopDownDataset",
    "ComposeKeypointsTransform",
    "DataLoader",
    "DirectoryDataset",
    "ExplorerDataset",
    "HeatmapGenerator",
    "ImagenetClassificationDataset",
    "InferenceDataset",
    "InferenceVideoDataset",
    "JointsGenerator",
    "KeypointsTransform",
    "MPII_FLIP_INDEX",
    "MPII_LABELS",
    "MPII_LIMBS",
    "MpiiKeypointsDataset",
    "NormalizeKeypoints",
    "RandomAffineTransform",
    "RandomHorizontalFlip",
    "VideoProcessingResult",
    "affine_transform_point",
    "center_crop",
    "collate",
    "collate_topdown",
    "collate_classification",
    "get_affine_transform",
    "get_aug_affine_matrix",
    "get_coco_joints",
    "get_crowd_mask",
    "get_multi_scale_size",
    "inverse_normalize",
    "normalize",
    "polygons_to_mask",
    "prebake_annotations",
    "random_resized_crop",
    "resize_align_multi_scale",
    "resize_short",
    "segmentation_to_mask",
    "transform_coords_inverse",
]
