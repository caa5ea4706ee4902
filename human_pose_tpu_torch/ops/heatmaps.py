"""Heatmap resizing and multi-stage aggregation, NCHW (port of
human_pose_tpu/ops/heatmaps.py in its channel-major form)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def resize_bilinear(hms: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Bilinear resize of ``[N, C, H, W]`` maps to ``(h, w)``, half-pixel
    centers (``align_corners=False``, the reference's interpolate)."""
    return F.interpolate(hms, size=(h, w), mode="bilinear", align_corners=False)


def match_heatmaps_size(heatmaps: list) -> list:
    """Resize all stages to the last (largest) stage's spatial size."""
    h, w = heatmaps[-1].shape[2:4]
    return [resize_bilinear(hm, h, w) for hm in heatmaps[:-1]] + [heatmaps[-1]]


def average_stages(heatmaps: list) -> torch.Tensor:
    """Mean over the stage list after size matching."""
    matched = match_heatmaps_size(heatmaps)
    return sum(matched) / len(matched)
