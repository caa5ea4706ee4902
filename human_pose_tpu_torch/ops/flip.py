"""Flip-test (TTA) merging, NCHW (port of human_pose_tpu/ops/flip.py).

The second forward runs on the horizontally flipped image; keypoint heatmaps
are flipped back, channel-permuted with the left/right COCO swap and
averaged with the direct pass; tag maps are flipped back + permuted and
stacked as a second embedding dimension (not averaged).
"""

from __future__ import annotations

import torch

from ..device import constant

# reference src/keypoints/transforms.py:11
COCO_FLIP_INDEX = (0, 2, 1, 4, 3, 6, 5, 8, 7, 10, 9, 12, 11, 14, 13, 16, 15)


def flip_back(hms: torch.Tensor, flip_index=COCO_FLIP_INDEX) -> torch.Tensor:
    """Undo a horizontal flip on ``[N, K, H, W]`` maps: mirror width and swap
    left/right keypoint channels."""
    idx = constant(tuple(int(i) for i in flip_index), torch.int64, hms.device)
    return hms.flip(3)[:, idx]


def merge_flip_heatmaps(hms: torch.Tensor, flip_hms: torch.Tensor, flip_index=COCO_FLIP_INDEX):
    """Average direct and flipped-back keypoint heatmaps."""
    return (hms + flip_back(flip_hms, flip_index)) / 2.0


def stack_flip_tags(tags: torch.Tensor, flip_tags: torch.Tensor, flip_index=COCO_FLIP_INDEX):
    """Stack direct tags and flipped-back tags along a new embedding dim:
    ``[N, K, H, W]`` x2 -> ``[N, K, 2, H, W]`` (the layout of
    ``decode_batch``'s stacked tags)."""
    return torch.stack([tags, flip_back(flip_tags, flip_index)], dim=2)
