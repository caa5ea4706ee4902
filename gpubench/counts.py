"""The yardstick's arithmetic: the H100's peaks, rooflines, and the FLOP
count of the reference networks.

Peaks: NVIDIA's H100 SXM data sheet, dense rates at the 700 W limit.
``bound`` and ``refine_bound`` count a kernel's bytes and operations for its
inputs; ``flops`` counts the reference network's convolutions, transposed
convolutions and matrix products with ``FlopCounterMode`` (2 operations a
multiply-add; resizes, BatchNorm and elementwise ops not counted) on meta
tensors, so the count follows the published shapes, not the program's
kernels.
"""

from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

from .reference.nets import Net, spec

PEAK_BYTES_S = 3.35e12
PEAK_FP32_S = 67e12
PEAK_TF32_S = 495e12
PEAK_BF16_S = 989e12


def bound(nbytes: float, ops: float, peak_ops_s: float = PEAK_FP32_S):
    """``(bound_ms, bound_by)``: the larger of the bytes over the HBM rate and
    the operations over the peak rate of their type."""
    t_bytes, t_ops = nbytes / PEAK_BYTES_S * 1e3, ops / peak_ops_s * 1e3
    return (t_ops, "operations") if t_ops > t_bytes else (t_bytes, "bytes")


def refine_bound(b: int, k: int, e: int, hw: int, p: int, active: int):
    """``(bound_ms, bound_by)`` of the refine argmax over ``b`` images of
    ``k`` maps of ``hw`` pixels, ``e`` tag dims and ``p`` person slots, of
    which ``active`` (summed over the images) are scanned: maps, person tags
    and counts read once, indices written once; per (pixel, active person)
    5 float32 operations for e = 1, else 3e + 4 (sub, square, add a dim;
    sqrt, round, sub, compare)."""
    nbytes = 4 * (b * k * hw + b * k * e * hw + b * p * e + b + b * k * p)
    ops = k * hw * active * (5 if e == 1 else 3 * e + 4)
    return bound(nbytes, ops)


def flops(arch: dict, input_hw: tuple, train: bool = False) -> float:
    """Operations of one image through the reference network at
    ``input_hw``: a forward, or with ``train`` a forward and the backward
    (gradients of every weight and of every activation but the image's)."""
    params = {n: torch.empty(s, device="meta", requires_grad=train and k != "bn_count")
              for n, s, k in spec(arch, input_hw)}
    x = torch.empty((1, 3, *input_hw), device="meta")
    with FlopCounterMode(display=False) as counter:
        out = Net(arch, params, train=train)(x)
        if train:
            leaves = [o for o in (out[0] + [out[1]] if isinstance(out, tuple) else [out])]
            torch.autograd.backward([o.sum() for o in leaves])
    return float(counter.get_total_flops())
