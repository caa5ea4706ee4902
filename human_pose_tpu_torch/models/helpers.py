"""Shared building blocks, NCHW (port of human_pose_tpu/models/helpers.py;
counterpart of reference src/base/architectures/helpers.py: ConvBnAct,
SEBlock)."""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F
from torch import nn

from .norm import batch_norm


class ConvBnAct(nn.Module):
    """conv (padding ``(kernel - 1) // 2``) + BN [+ ``activation``], as
    ``conv`` / ``bn``."""

    def __init__(self, cin: int, features: int, kernel: int = 3, stride: int = 1,
                 activation: Callable | None = torch.relu, use_bias: bool = False):
        super().__init__()
        self.conv = nn.Conv2d(cin, features, kernel, stride, (kernel - 1) // 2, bias=use_bias)
        self.bn = batch_norm(features)
        self.activation = activation

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.bn(self.conv(x))
        return x if self.activation is None else self.activation(x)


class SEBlock(nn.Module):
    """Squeeze-and-excitation channel attention: the spatial mean through
    ``fc1`` (to ``max(1, channels // reduction)``), ReLU, ``fc2`` and a
    sigmoid scales each channel."""

    def __init__(self, channels: int, reduction: int = 16):
        super().__init__()
        self.fc1 = nn.Linear(channels, max(1, channels // reduction))
        self.fc2 = nn.Linear(max(1, channels // reduction), channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = torch.sigmoid(self.fc2(torch.relu(self.fc1(x.mean((2, 3))))))
        return x * s[:, :, None, None]


def max_pool_2x2(x: torch.Tensor) -> torch.Tensor:
    """2x2 stride-2 max pool; an odd size is floored, as flax's VALID."""
    return F.max_pool2d(x, 2, 2)


def upsample_nearest_2x(x: torch.Tensor) -> torch.Tensor:
    return F.interpolate(x, scale_factor=2, mode="nearest")
