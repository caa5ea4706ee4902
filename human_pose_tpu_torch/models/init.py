"""Seeded random weights for models built without a checkpoint, and the
keypoints and classification training inits (port of
human_pose_tpu/models/init.py)."""

from __future__ import annotations

import math

import torch
from torch import nn


# std of a unit normal truncated to [-2, 2]: flax's truncated initializers
# divide by it so the drawn values keep the requested std
TRUNCATED_NORMAL_STD = 0.87962566103423978


def _flax_dense_(m: nn.Linear, generator: torch.Generator) -> None:
    """flax ``nn.Dense``'s default: a unit normal truncated to [-2, 2] (drawn
    by its inverse CDF, as ``jax.random.truncated_normal``) scaled to std
    1/sqrt(in_features), bias 0; drawn on the CPU."""
    vals = nn.init.trunc_normal_(torch.empty(m.weight.shape), generator=generator)
    m.weight.copy_(vals * (1.0 / math.sqrt(m.in_features) / TRUNCATED_NORMAL_STD))
    if m.bias is not None:
        m.bias.zero_()


@torch.no_grad()
def init_flax_default_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Fill conv and transposed-conv kernels after flax's default initializer
    (LeCun normal: a unit normal truncated to [-2, 2], drawn by its inverse
    CDF as ``jax.random.truncated_normal``, scaled by 1/sqrt(fan_in) /
    ``TRUNCATED_NORMAL_STD`` so its std is 1/sqrt(fan_in); fan_in =
    in_channels * kH * kW), Linear kernels as flax's ``Dense`` default
    (``_flax_dense_``), zero biases and leave BN at (1, 0) with unit running
    variance — the weights ``model.init`` gives the JAX package's benchmark.
    Draws on the CPU from ``generator`` so a seed gives the same weights on
    every device."""
    for m in model.modules():
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
            w = m.weight
            kh, kw = w.shape[-2:]
            cin = w.shape[0] if isinstance(m, nn.ConvTranspose2d) else w.shape[1]
            std = 1.0 / math.sqrt(cin * kh * kw) / TRUNCATED_NORMAL_STD
            vals = nn.init.trunc_normal_(torch.empty(w.shape), generator=generator)
            w.copy_(vals * std)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.Linear):
            _flax_dense_(m, generator)
    return model


@torch.no_grad()
def init_keypoints_weights_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """The keypoints training init: every conv and transposed-conv kernel
    drawn from N(0, 0.001), every conv bias zeroed, BN left as it is ((1, 0)
    on a new model); a Linear (``SEBlock``'s) keeps flax's ``Dense`` default
    (``_flax_dense_``: the JAX init leaves 2-D kernels and zeroes biases).
    Draws on the CPU from ``generator``, so a seed gives the same weights on
    every device; the JAX package's ``fold_in`` stream is not reproduced,
    only the distribution."""
    for m in model.modules():
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
            m.weight.copy_(torch.empty(m.weight.shape).normal_(generator=generator) * 0.001)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.Linear):
            _flax_dense_(m, generator)
    return model


@torch.no_grad()
def init_classification_weights_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """The classification training init: every conv kernel kaiming-normal
    with fan_out (the gain for ReLU), std = sqrt(2 / (kH * kW * out)), conv
    biases zero; the Linear classifier and BN keep flax's defaults (LeCun
    normal over ``in_features`` with a zero bias; (1, 0)), which a new torch
    module does not have, so the Linear is drawn here too. Draws on the CPU
    from ``generator``; the JAX package's ``fold_in`` stream is not
    reproduced, only the distribution."""
    for m in model.modules():
        if isinstance(m, nn.Conv2d):
            out, _, kh, kw = m.weight.shape
            std = math.sqrt(2.0 / (kh * kw * out))
            m.weight.copy_(torch.empty(m.weight.shape).normal_(generator=generator) * std)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.Linear):
            _flax_dense_(m, generator)
    return model
