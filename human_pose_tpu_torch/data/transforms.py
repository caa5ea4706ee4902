"""Host-side image normalization, channel-last float32 (port of
``normalize``, ``inverse_normalize`` and ``COCO_FLIP_INDEX`` of
human_pose_tpu/data/transforms.py; the augmentations come with training)."""

from __future__ import annotations

import numpy as np

from ..constants import IMAGENET_MEAN, IMAGENET_STD

# reference src/keypoints/transforms.py:11
COCO_FLIP_INDEX = [0, 2, 1, 4, 3, 6, 5, 8, 7, 10, 9, 12, 11, 14, 13, 16, 15]


def normalize(image: np.ndarray, mean=IMAGENET_MEAN, std=IMAGENET_STD) -> np.ndarray:
    """uint8 HWC -> float32 HWC normalized."""
    img = image.astype(np.float32) / 255.0
    return (img - np.asarray(mean, np.float32)) / np.asarray(std, np.float32)


def inverse_normalize(image: np.ndarray, mean=IMAGENET_MEAN, std=IMAGENET_STD) -> np.ndarray:
    """float32 HWC normalized -> uint8 HWC. uint8 passes through unchanged:
    compact inputs keep images un-normalized until the device step."""
    if image.dtype == np.uint8:
        return image
    img = image * np.asarray(std, np.float32) + np.asarray(mean, np.float32)
    return np.clip(img * 255.0, 0, 255).astype(np.uint8)
