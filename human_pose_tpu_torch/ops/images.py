"""Device-side image normalization for the compact uint8 input path (port of
human_pose_tpu/ops/images.py, NCHW)."""

from __future__ import annotations

import torch

from ..constants import IMAGENET_MEAN, IMAGENET_STD


def prep_images(images: torch.Tensor, out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """Normalize uint8 ``[N, 3, H, W]`` images on their device with the
    ImageNet mean/std; float images pass through. ``out_dtype`` casts the
    normalized result."""
    if images.is_floating_point():
        return images
    mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32, device=images.device)[:, None, None]
    std = torch.tensor(IMAGENET_STD, dtype=torch.float32, device=images.device)[:, None, None]
    out = (images.to(torch.float32) / 255.0 - mean) / std
    return out if out_dtype is None else out.to(out_dtype)
