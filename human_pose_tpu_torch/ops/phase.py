"""Phase layout of full-resolution maps (port of the helpers in
human_pose_tpu/ops/pallas_aggregate.py).

The fused decode front end keeps a full-resolution ``[H, W]`` map as 4x4
phase planes ``F[ry][rx][i, j] = M[4i + ry, 4j + rx]`` of shape
``[H/4, W/4]`` (``avg_phase``/``sup_phase`` of ``fused_aggregate``), and its
tag maps at quarter resolution. These helpers read both without building the
dense full-resolution map. Plain torch, any device.
"""

from __future__ import annotations

import torch

# 4x ``align_corners=False`` upsample taps: output phase r of row i takes
# (i-1, i) for r = 0, 1 and (i, i+1) for r = 2, 3 with these (left, right)
# weights; at the first and last row the edge tap collapses to an exact copy
UP4_W = ((0.375, 0.625), (0.125, 0.875), (0.875, 0.125), (0.625, 0.375))


def phase_to_dense(phase_map: torch.Tensor) -> torch.Tensor:
    """``[..., 4, 4, H4, W4]`` phase layout -> ``[..., 4*H4, 4*W4]``."""
    *lead, _, _, h4, w4 = phase_map.shape
    n = len(lead)
    perm = (*range(n), n + 2, n, n + 3, n + 1)
    return phase_map.permute(perm).reshape(*lead, 4 * h4, 4 * w4)


def dense_to_phase(dense: torch.Tensor) -> torch.Tensor:
    """``[..., H, W]`` (H, W multiples of 4) -> ``[..., 4, 4, H/4, W/4]``."""
    *lead, h, w = dense.shape
    n = len(lead)
    split = dense.reshape(*lead, h // 4, 4, w // 4, 4)
    return split.permute(*range(n), n + 1, n + 3, n, n + 2).contiguous()


def phase_index(yy: torch.Tensor, xx: torch.Tensor, h4: int, w4: int) -> torch.Tensor:
    """Flat index into a ``reshape(..., 16*H4*W4)`` phase-layout map for
    integer full-resolution coordinates ``(y, x)``."""
    return ((yy % 4) * 4 + xx % 4) * (h4 * w4) + (yy // 4) * w4 + xx // 4


def phase_gather(phase_map: torch.Tensor, yy: torch.Tensor, xx: torch.Tensor) -> torch.Tensor:
    """Values of ``phase_map [..., K, 4, 4, H4, W4]`` at integer ``(y, x)``;
    ``yy, xx [..., K, N]`` index joint k's map in row k -> ``[..., K, N]``."""
    h4, w4 = phase_map.shape[-2:]
    flat = phase_map.reshape(*phase_map.shape[:-4], 16 * h4 * w4)
    return torch.gather(flat, -1, phase_index(yy, xx, h4, w4).to(torch.int64))


def sample_tags_bilinear(tags_lo: torch.Tensor, yy: torch.Tensor, xx: torch.Tensor) -> torch.Tensor:
    """The 4x-upsampled tag surface at integer full-resolution ``(y, x)``,
    without building it: a two-tap lerp down the rows, then along the row,
    with the ``UP4_W`` weights (edge taps collapse to a copy), the same
    float32 operations as the refine kernel's in-kernel upsample.

    ``tags_lo [..., K, E, H4, W4]``, ``yy, xx [..., K, M]`` int ->
    ``[..., K, M, E]``."""
    h4, w4 = tags_lo.shape[-2:]
    e = tags_lo.shape[-3]
    dev = tags_lo.device
    wl_tab = torch.tensor([w[0] for w in UP4_W], dtype=torch.float32, device=dev)
    lo_off = torch.tensor([-1, -1, 0, 0], dtype=torch.int64, device=dev)
    yy, xx = yy.to(torch.int64), xx.to(torch.int64)
    ry, rx = yy % 4, xx % 4
    y_l = torch.clamp(yy // 4 + lo_off[ry], 0, h4 - 1)
    y_r = torch.clamp(yy // 4 + lo_off[ry] + 1, 0, h4 - 1)
    x_l = torch.clamp(xx // 4 + lo_off[rx], 0, w4 - 1)
    x_r = torch.clamp(xx // 4 + lo_off[rx] + 1, 0, w4 - 1)
    wy, wx = wl_tab[ry][..., None], wl_tab[rx][..., None]  # [..., K, M, 1]
    flat = tags_lo.reshape(*tags_lo.shape[:-2], h4 * w4)  # [..., K, E, HW4]

    def g(ys, xs):  # [..., K, M] -> [..., K, M, E]
        idx = (ys * w4 + xs).unsqueeze(-2).expand(*ys.shape[:-1], e, ys.shape[-1])
        return torch.gather(flat, -1, idx).transpose(-1, -2)

    def lerp_rows(xs):
        top, bot = g(y_l, xs), g(y_r, xs)
        return torch.where((y_l == y_r)[..., None], top, wy * top + (1 - wy) * bot)

    left, right = lerp_rows(x_l), lerp_rows(x_r)
    return torch.where((x_l == x_r)[..., None], left, wx * left + (1 - wx) * right)
