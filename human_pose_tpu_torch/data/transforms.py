"""Host-side data transforms, NumPy and cv2 (cv2 imported where it is used),
channel-last outputs (port of the keypoints half of
human_pose_tpu/data/transforms.py; the classification transforms come with
the classification model, ROADMAP module 12).

* ``normalize`` / ``inverse_normalize``: uint8 HWC <-> float32 HWC with the
  ImageNet mean and std.
* keypoints training (reference src/keypoints/transforms.py):
  ``ComposeKeypointsTransform`` over ``(image, mask_list, joints_list)``;
  ``RandomAffineTransform`` with a scale in 200-px units, rotation about
  the output centre and a random translate; ``RandomHorizontalFlip`` with
  the COCO left/right swap; ``NormalizeKeypoints``; ``KeypointsTransform``
  with its train and inference pipelines. Every random draw comes from the
  per-sample ``rng``, in the JAX package's order, so one seed gives the
  same sample bit for bit.
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np

from ..constants import IMAGENET_MEAN, IMAGENET_STD
from .affine import get_aug_affine_matrix

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


class ComposeKeypointsTransform:
    """Transforms draw randomness only from the per-sample ``rng``, so the
    pipeline is deterministic in (seed, epoch, index) and resumable."""

    def __init__(self, transforms: Sequence[Callable]):
        self.transforms = list(transforms)

    def __call__(self, image, mask_list, joints_list, rng: np.random.Generator | None = None):
        if rng is None:
            rng = np.random.default_rng()
        for t in self.transforms:
            image, mask_list, joints_list = t(image, mask_list, joints_list, rng)
        return image, mask_list, joints_list


class RandomAffineTransform:
    """Reference src/keypoints/transforms.py:75-172."""

    def __init__(
        self,
        out_size: int,
        hm_sizes: Sequence[int],
        max_rotation: float = 0.0,
        min_scale: float = 1.0,
        max_scale: float = 1.0,
        scale_type: str = "short",
        max_translate: int = 0,
    ):
        if scale_type not in ("short", "long"):
            raise ValueError(f"scale_type must be 'short' or 'long', got {scale_type!r}")
        self.out_size = out_size
        self.hm_sizes = list(hm_sizes)
        self.max_rotation = max_rotation
        self.min_scale = min_scale
        self.max_scale = max_scale
        self.scale_type = scale_type
        self.max_translate = max_translate

    @staticmethod
    def _affine_joints(joints_xy: np.ndarray, mat: np.ndarray) -> np.ndarray:
        shape = joints_xy.shape
        flat = joints_xy.reshape(-1, 2)
        ones = np.ones((flat.shape[0], 1))
        return (np.concatenate([flat, ones], axis=1) @ mat.T).reshape(shape)

    def __call__(self, image, mask_list, joints_list, rng: np.random.Generator):
        import cv2

        h, w = image.shape[:2]
        center = np.array((w / 2.0, h / 2.0))
        scale = (min(h, w) if self.scale_type == "short" else max(h, w)) / 200.0
        scale *= rng.random() * (self.max_scale - self.min_scale) + self.min_scale
        rot = (rng.random() * 2 - 1) * self.max_rotation
        if self.max_translate > 0:
            mt = int(self.max_translate * scale)
            center[0] += rng.integers(-mt, mt)
            center[1] += rng.integers(-mt, mt)

        for i, hm_size in enumerate(self.hm_sizes):
            mat = get_aug_affine_matrix(center, scale, (hm_size, hm_size), rot)[:2]
            warped = cv2.warpAffine(
                (mask_list[i] * 255).astype(np.uint8), mat, (hm_size, hm_size)
            ) / 255.0
            mask_list[i] = (warped > 0.5).astype(np.float32)
            joints_list[i][:, :, 0:2] = self._affine_joints(joints_list[i][:, :, 0:2], mat)

        mat_in = get_aug_affine_matrix(center, scale, (self.out_size, self.out_size), rot)[:2]
        image = cv2.warpAffine(image, mat_in, (self.out_size, self.out_size))
        return image, mask_list, joints_list


class RandomHorizontalFlip:
    """Reference src/keypoints/transforms.py:56-72."""

    def __init__(self, flip_index=COCO_FLIP_INDEX, hm_sizes: Sequence[int] = (), p: float = 0.5):
        self.flip_index = list(flip_index)
        self.hm_sizes = list(hm_sizes)
        self.p = p

    def __call__(self, image, mask_list, joints_list, rng: np.random.Generator):
        if rng.random() < self.p:
            image = np.ascontiguousarray(image[:, ::-1])
            for i, hm_size in enumerate(self.hm_sizes):
                mask_list[i] = np.ascontiguousarray(mask_list[i][:, ::-1])
                joints_list[i] = joints_list[i][:, self.flip_index]
                joints_list[i][:, :, 0] = hm_size - joints_list[i][:, :, 0] - 1
        return image, mask_list, joints_list


class NormalizeKeypoints:
    def __init__(self, mean=IMAGENET_MEAN, std=IMAGENET_STD):
        self.mean, self.std = mean, std

    def __call__(self, image, mask_list, joints_list, rng=None):
        return normalize(image, self.mean, self.std), mask_list, joints_list


class KeypointsTransform:
    """Train and inference pipelines (reference transforms.py:175-220)."""

    def __init__(
        self,
        out_size: int = 512,
        hm_resolutions: Sequence[float] = (0.25, 0.5),
        max_rotation: float = 30,
        min_scale: float = 0.75,
        max_scale: float = 1.5,
        scale_type: str = "short",
        max_translate: int = 40,
        mean=IMAGENET_MEAN,
        std=IMAGENET_STD,
        normalize: bool = True,
    ):
        """``normalize=False`` leaves the image uint8 (compact host batches:
        a quarter of the collate copy and of the host-to-device transfer);
        the train and val steps normalize on the device (``prep_images``)."""
        self.out_size = out_size
        self.mean, self.std = mean, std
        hm_sizes = [int(r * out_size) for r in hm_resolutions]
        self.hm_sizes = hm_sizes
        tail = [NormalizeKeypoints(mean, std)] if normalize else []
        self.train = ComposeKeypointsTransform(
            [
                RandomAffineTransform(
                    out_size, hm_sizes, max_rotation, min_scale, max_scale,
                    scale_type, max_translate,
                ),
                RandomHorizontalFlip(COCO_FLIP_INDEX, hm_sizes, 0.5),
            ]
            + tail
        )
        self.inference = ComposeKeypointsTransform(
            [RandomAffineTransform(out_size, hm_sizes, 0, 1, 1, scale_type, 0)]
            + tail
        )

    @staticmethod
    def inverse_transform(image: np.ndarray) -> np.ndarray:
        return inverse_normalize(image)
