"""Device-side image normalization for the compact uint8 input path (port of
human_pose_tpu/ops/images.py, NCHW)."""

from __future__ import annotations

import torch

from ..constants import IMAGENET_MEAN, IMAGENET_STD
from ..device import constant


def prep_images(images: torch.Tensor, out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """Normalize uint8 ``[N, 3, H, W]`` images on their device with the
    ImageNet mean/std; float images pass through. ``out_dtype`` casts the
    normalized result."""
    if images.is_floating_point():
        return images
    dev = images.device
    mean = constant(IMAGENET_MEAN, torch.float32, dev)[:, None, None]
    std = constant(IMAGENET_STD, torch.float32, dev)[:, None, None]
    # a true division on every device: a Python-scalar divisor makes CUDA
    # multiply by its reciprocal, an ulp off the CPU's and JAX's quotient
    scale = constant(255.0, torch.float32, dev)
    out = (images.to(torch.float32) / scale - mean) / std
    return out if out_dtype is None else out.to(out_dtype)
