"""Host-side data code (NumPy/cv2): the inference path's part of it. The
dataset classes and the training augmentations come with batched eval and
training."""

from .affine import (
    affine_transform_point,
    get_affine_transform,
    get_multi_scale_size,
    resize_align_multi_scale,
    transform_coords_inverse,
)
from .coco import COCO_LABELS, COCO_LIMBS
from .transforms import COCO_FLIP_INDEX, inverse_normalize, normalize

__all__ = [
    "COCO_FLIP_INDEX",
    "COCO_LABELS",
    "COCO_LIMBS",
    "affine_transform_point",
    "get_affine_transform",
    "get_multi_scale_size",
    "inverse_normalize",
    "normalize",
    "resize_align_multi_scale",
    "transform_coords_inverse",
]
