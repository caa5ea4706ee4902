"""Seeded weights for a configuration, made on the device in a few large
calls and handed alike to the program and to the reference.

Flax's default initializers, the weights the JAX package's benchmarks
used: convolution, transposed-convolution and linear kernels are a unit
normal truncated to [-2, 2], drawn by its inverse CDF and scaled to a
standard deviation of 1 / sqrt(fan_in) (fan_in: input channels times the
kernel's area, or a linear layer's inputs); biases 0; BatchNorm scale 1,
shift 0, running mean 0 and running variance 1.
"""

from __future__ import annotations

import math

import torch

# std of a unit normal truncated to [-2, 2]
TRUNCATED_STD = 0.87962566103423978
KERNELS = ("conv", "deconv", "linear")


def fan_in(shape: tuple, kind: str) -> int:
    if kind == "conv":
        return shape[1] * shape[2] * shape[3]
    if kind == "deconv":
        return shape[0] * shape[2] * shape[3]
    return shape[1]


def make_weights(spec: list, seed: int, device) -> dict:
    """``spec`` ``[(name, shape, kind)]`` (``reference.nets.spec``) -> name
    -> tensor on ``device``: float32, the BatchNorm counters int64."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % 2**63)
    kernels = [(n, s, k) for n, s, k in spec if k in KERNELS]
    total = sum(math.prod(s) for _, s, _ in kernels)
    lo, hi = (1 + math.erf(-2 / math.sqrt(2))) / 2, (1 + math.erf(2 / math.sqrt(2))) / 2
    u = torch.rand(total, generator=gen, device=device, dtype=torch.float32)
    draws = torch.erfinv(2 * (lo + (hi - lo) * u) - 1).mul_(math.sqrt(2))
    out, at = {}, 0
    for name, shape, kind in kernels:
        n = math.prod(shape)
        scale = 1 / math.sqrt(fan_in(shape, kind)) / TRUNCATED_STD
        out[name] = draws[at:at + n].view(shape).mul_(scale)
        at += n
    fill = {"bias": 0.0, "bn_bias": 0.0, "bn_mean": 0.0, "bn_weight": 1.0, "bn_var": 1.0}
    for name, shape, kind in spec:
        if kind in fill:
            out[name] = torch.full(shape, fill[kind], dtype=torch.float32, device=device)
        elif kind == "bn_count":
            out[name] = torch.zeros((), dtype=torch.int64, device=device)
    return {name: out[name] for name, _, _ in spec}
