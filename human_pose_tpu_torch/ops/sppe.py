"""Single-person (SPPE) heatmap decode (port of human_pose_tpu/ops/sppe.py;
counterpart of the reference's ``SPPEHeatmapParser``,
src/keypoints/grouping.py:10-52): a per-keypoint argmax over the detection
heatmap gives integer (x, y) and the heatmap value as the score; one person
an image, no detection threshold (the caller filters with ``det_thr``).

A plain argmax in the JAX package, not a Pallas kernel: torch ops on every
device. Ties go to the FIRST row-major maximum, as ``jnp.argmax``; the
index is taken as the smallest flat index holding the maximum (or a NaN,
which ``jnp.argmax`` treats as the maximum) rather than trusting an
argmax's tie order.
"""

from __future__ import annotations

import torch


def sppe_parse(heatmaps: torch.Tensor) -> torch.Tensor:
    """Single-person joints from detection heatmaps ``[N, K, H, W]``:
    ``[N, 1, K, 3]`` float32, (x, y, score) a keypoint, coordinates in
    heatmap pixels (integer-valued)."""
    n, k, h, w = heatmaps.shape
    flat = heatmaps.reshape(n, k, h * w)
    peak = flat.amax(dim=-1, keepdim=True)
    hit = (flat == peak) | torch.isnan(flat)
    pos = torch.arange(h * w, device=flat.device).expand_as(flat)
    idx = torch.where(hit, pos, h * w).amin(dim=-1)  # [N, K]
    score = flat.gather(-1, idx[..., None])[..., 0]
    joints = torch.stack([(idx % w).float(), (idx // w).float(), score.float()], dim=-1)
    return joints[:, None]
