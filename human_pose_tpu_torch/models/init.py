"""Seeded random weights for models built without a checkpoint, and the
keypoints training init (port of human_pose_tpu/models/init.py)."""

from __future__ import annotations

import math

import torch
from torch import nn


@torch.no_grad()
def init_flax_default_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Fill conv and transposed-conv kernels like flax's default initializer
    (LeCun normal: std = 1/sqrt(fan_in), fan_in = in_channels * kH * kW,
    truncated at 2 std), zero biases and leave BN at (1, 0) with unit running
    variance — the weights ``model.init`` gives the JAX package's benchmark.
    Draws on the CPU from ``generator`` so a seed gives the same weights on
    every device."""
    for m in model.modules():
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
            w = m.weight
            kh, kw = w.shape[-2:]
            cin = w.shape[0] if isinstance(m, nn.ConvTranspose2d) else w.shape[1]
            std = 1.0 / math.sqrt(cin * kh * kw) / 0.87962566103423978
            vals = torch.empty(w.shape).normal_(generator=generator).clamp_(-2.0, 2.0)
            w.copy_(vals * std)
            if m.bias is not None:
                m.bias.zero_()
    return model


@torch.no_grad()
def init_keypoints_weights_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """The keypoints training init: every conv and transposed-conv kernel
    drawn from N(0, 0.001), every conv bias zeroed, BN left as it is ((1, 0)
    on a new model). Draws on the CPU from ``generator``, so a seed gives the
    same weights on every device; the JAX package's ``fold_in`` stream is not
    reproduced, only the distribution."""
    for m in model.modules():
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
            m.weight.copy_(torch.empty(m.weight.shape).normal_(generator=generator) * 0.001)
            if m.bias is not None:
                m.bias.zero_()
    return model
