"""Host-side data transforms, NumPy and cv2 (cv2 imported where it is used),
channel-last outputs (port of human_pose_tpu/data/transforms.py).

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
* classification (reference src/classification/transforms.py):
  ``random_resized_crop`` (10 tries of a scale and a log-uniform aspect,
  then a center crop of the short-side resize) and a horizontal flip for
  training; ``resize_short`` to ``size / 0.875`` and ``center_crop`` for
  inference; ``ClassificationTransform``. The same draws in the same order
  as the JAX package's, so crops equal its bit for bit.
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


# -- classification ---------------------------------------------------------------------

def random_resized_crop(image: np.ndarray, size: int, rng: np.random.Generator, scale=(0.08, 1.0),
                        ratio=(3 / 4, 4 / 3)) -> np.ndarray:
    """A crop of a random area share (``scale``) and aspect (log-uniform in
    ``ratio``) resized to ``size`` x ``size``; after 10 tries that do not
    fit, the center crop of the short-side resize."""
    import cv2

    h, w = image.shape[:2]
    area = h * w
    for _ in range(10):
        target_area = rng.uniform(*scale) * area
        log_ratio = (np.log(ratio[0]), np.log(ratio[1]))
        aspect = np.exp(rng.uniform(*log_ratio))
        cw = int(round(np.sqrt(target_area * aspect)))
        ch = int(round(np.sqrt(target_area / aspect)))
        if 0 < cw <= w and 0 < ch <= h:
            x0 = int(rng.integers(0, w - cw + 1))
            y0 = int(rng.integers(0, h - ch + 1))
            crop = image[y0 : y0 + ch, x0 : x0 + cw]
            return cv2.resize(crop, (size, size), interpolation=cv2.INTER_LINEAR)
    return center_crop(resize_short(image, size), size)


def resize_short(image: np.ndarray, size: int) -> np.ndarray:
    """Bilinear resize so that the short side is ``size``."""
    import cv2

    h, w = image.shape[:2]
    if h < w:
        nh, nw = size, int(round(w * size / h))
    else:
        nh, nw = int(round(h * size / w)), size
    return cv2.resize(image, (nw, nh), interpolation=cv2.INTER_LINEAR)


def center_crop(image: np.ndarray, size: int) -> np.ndarray:
    h, w = image.shape[:2]
    y0 = max(0, (h - size) // 2)
    x0 = max(0, (w - size) // 2)
    return image[y0 : y0 + size, x0 : x0 + size]


class ClassificationTransform:
    """Reference src/classification/transforms.py:7-31."""

    def __init__(self, out_size: int = 224, mean=IMAGENET_MEAN, std=IMAGENET_STD,
                 normalize: bool = True):
        """``normalize=False`` ships uint8 crops and normalizes on the device
        (``prep_images``): the compact contract of ``KeypointsTransform``."""
        self.out_size = out_size
        self.mean, self.std = mean, std
        self.normalize = normalize

    def _finish(self, img: np.ndarray) -> np.ndarray:
        if self.normalize:
            return normalize(img, self.mean, self.std)
        if img.dtype != np.uint8:
            # the device-side prep passes floats through UN-normalized
            raise ValueError(f"normalize=False (compact) requires uint8 images, got {img.dtype}")
        return img

    def train(self, image: np.ndarray, rng: np.random.Generator | None = None) -> np.ndarray:
        if rng is None:
            rng = np.random.default_rng()
        img = random_resized_crop(image, self.out_size, rng)
        if rng.random() < 0.5:
            img = np.ascontiguousarray(img[:, ::-1])
        return self._finish(img)

    def inference(self, image: np.ndarray, rng=None) -> np.ndarray:
        img = resize_short(image, int(self.out_size / 0.875))
        return self._finish(center_crop(img, self.out_size))

    @staticmethod
    def inverse_transform(image: np.ndarray) -> np.ndarray:
        return inverse_normalize(image)
