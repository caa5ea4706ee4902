"""HRNet backbone, NCHW ``nn.Module``s (port of human_pose_tpu/models/hrnet.py).

Topology of the reference backbone (src/keypoints/architectures/hrnet.py):

* residual units: ``Bottleneck`` (expansion 4) / ``BasicBlock`` (expansion 1)
* ``HighResolutionBlock``: N residual units per scale branch
* ``FusionLayer`` after every HR block: strided 3x3 convs (high->low),
  identity (same scale), 1x1 conv + nearest 2^k upsample (low->high), summed
  + ReLU; the final stage's last fusion can emit a single high-res scale
* ``TransitionLayer`` between stages: 3x3 conv (stage1->2 only) or identity
  per existing branch, plus a stride-2 3x3 conv creating the new branch
* stem: two stride-2 3x3 convs 3->64->64

Submodules are named so that ``state_dict()`` keys are the reference's — the
keys ``utils.weights.torch_key_for`` emits — and a converted flax tree loads
with ``strict=True``. Only the plain layout exists here: the JAX package's
space-to-depth layout (models/s2d.py) is a TPU lane-packing of the same
parameters.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from .norm import batch_norm


def conv_bn(cin: int, cout: int, kernel: int, stride: int = 1, relu: bool = False) -> nn.Sequential:
    """conv (no bias) + BN [+ ReLU] as ``Sequential`` (keys ``.0`` / ``.1``)."""
    layers = [
        nn.Conv2d(cin, cout, kernel, stride, (kernel - 1) // 2, bias=False),
        batch_norm(cout),
    ]
    if relu:
        layers.append(nn.ReLU(inplace=True))
    return nn.Sequential(*layers)


class Bottleneck(nn.Module):
    """1x1 -> 3x3 -> 1x1 residual unit, expansion 4."""

    expansion = 4

    def __init__(self, cin: int, features: int):
        super().__init__()
        mid = features // self.expansion
        self.conv1 = nn.Conv2d(cin, mid, 1, bias=False)
        self.bn1 = batch_norm(mid)
        self.conv2 = nn.Conv2d(mid, mid, 3, 1, 1, bias=False)
        self.bn2 = batch_norm(mid)
        self.conv3 = nn.Conv2d(mid, features, 1, bias=False)
        self.bn3 = batch_norm(features)
        self.downsample = conv_bn(cin, features, 1) if cin != features else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = torch.relu(self.bn1(self.conv1(x)))
        out = torch.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        residual = x if self.downsample is None else self.downsample(x)
        return torch.relu(out + residual)


class BasicBlock(nn.Module):
    """Two 3x3 convs residual unit, expansion 1."""

    expansion = 1

    def __init__(self, cin: int, features: int):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, features, 3, 1, 1, bias=False)
        self.bn1 = batch_norm(features)
        self.conv2 = nn.Conv2d(features, features, 3, 1, 1, bias=False)
        self.bn2 = batch_norm(features)
        self.downsample = conv_bn(cin, features, 1) if cin != features else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = torch.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        residual = x if self.downsample is None else self.downsample(x)
        return torch.relu(out + residual)


_BLOCK_TYPES = {"bottleneck": Bottleneck, "basic": BasicBlock}


class HighResolutionBlock(nn.Module):
    """Per-scale stack of ``num_units`` residual units."""

    def __init__(self, num_units: int, block_type: str, in_channels: Sequence[int],
                 out_channels: Sequence[int]):
        super().__init__()
        block = _BLOCK_TYPES[block_type]
        self.scales_blocks = nn.ModuleList(
            nn.ModuleList(
                block(cin if j == 0 else cout, cout) for j in range(num_units)
            )
            for cin, cout in zip(in_channels, out_channels)
        )

    def forward(self, xs: list) -> list:
        outs = []
        for x, units in zip(xs, self.scales_blocks):
            for unit in units:
                x = unit(x)
            outs.append(x)
        return outs


class FusionLayer(nn.Module):
    """All-to-all scale fusion. Output scale i from input scale j:
    i > j: (i-j) stride-2 3x3 conv+BN, ReLU between (not after the last);
    i == j: identity; i < j: 1x1 conv + BN + nearest 2^(j-i) upsample.
    The contributions are summed and ReLU'd."""

    def __init__(self, channels: Sequence[int], num_scales_out: int):
        super().__init__()
        num_in = len(channels)
        layers = []
        for i in range(num_scales_out):
            row = []
            for j in range(num_in):
                if i > j:
                    row.append(nn.Sequential(*(
                        conv_bn(
                            channels[j], channels[i] if k == i - j - 1 else channels[j],
                            3, stride=2, relu=k != i - j - 1,
                        )
                        for k in range(i - j)
                    )))
                elif i < j:
                    row.append(nn.Sequential(
                        nn.Conv2d(channels[j], channels[i], 1, bias=False),
                        batch_norm(channels[i]),
                        nn.Upsample(scale_factor=2 ** (j - i), mode="nearest"),
                    ))
                else:
                    row.append(nn.Identity())
            layers.append(nn.ModuleList(row))
        self.scales_fusion_layers = nn.ModuleList(layers)

    def forward(self, xs: list) -> list:
        outs = []
        for row in self.scales_fusion_layers:
            acc = None
            for x, layer in zip(xs, row):
                y = layer(x)
                acc = y if acc is None else acc + y
            outs.append(torch.relu(acc))
        return outs


class TransitionLayer(nn.Module):
    """Per existing branch a 3x3 conv+BN+ReLU (after stage 1 only) or
    identity, plus a stride-2 3x3 conv+BN+ReLU on the lowest scale creating
    the new branch."""

    def __init__(self, in_channels: Sequence[int], out_channels: Sequence[int],
                 is_first_stage: bool):
        super().__init__()
        blocks = [
            conv_bn(cin, cout, 3, relu=True) if is_first_stage else nn.Identity()
            for cin, cout in zip(in_channels, out_channels)
        ]
        blocks.append(conv_bn(in_channels[-1], out_channels[-1], 3, stride=2, relu=True))
        self.transition_blocks = nn.ModuleList(blocks)

    def forward(self, xs: list) -> list:
        outs = [block(x) for x, block in zip(xs, self.transition_blocks)]
        outs.append(self.transition_blocks[-1](xs[-1]))
        return outs


class HighResolutionStage(nn.Module):
    """``num_blocks`` x (HR block + fusion) + transition unless final."""

    def __init__(self, num_blocks: int, num_units: int, block_type: str,
                 in_channels: Sequence[int], out_channels: Sequence[int],
                 is_final_stage: bool, is_first_stage: bool,
                 final_stage_single_scale: bool = False):
        super().__init__()
        expansion = _BLOCK_TYPES[block_type].expansion
        num_scales = len(in_channels)
        block_out = [c * expansion for c in in_channels]
        # bottleneck stage 1 fuses at 256 ch (its single-scale "fusion" is
        # identity + ReLU); basic stages keep [C, 2C, ...] per branch
        fuse_ch = block_out if block_type == "bottleneck" else list(out_channels[:num_scales])
        blocks = []
        cin = list(in_channels)
        for b in range(num_blocks):
            blocks.append(HighResolutionBlock(num_units, block_type, cin, block_out))
            single = is_final_stage and b == num_blocks - 1 and final_stage_single_scale
            blocks.append(FusionLayer(fuse_ch, 1 if single else num_scales))
            cin = fuse_ch
        self.blocks = nn.ModuleList(blocks)
        self.transition_layer = (
            None if is_final_stage
            else TransitionLayer(fuse_ch, out_channels, is_first_stage)
        )

    def forward(self, xs: list) -> list:
        for block in self.blocks:
            xs = block(xs)
        return xs if self.transition_layer is None else self.transition_layer(xs)


def stage_configs(C: int, num_blocks_per_stage: Sequence[int] = (1, 1, 4, 3),
                  num_units: int = 4) -> list:
    """The 4-stage HRNet topology table: ``(num_blocks, num_units,
    block_type, in_channels, out_channels)`` per stage."""
    C2, C4, C8 = 2 * C, 4 * C, 8 * C
    nb, nu = num_blocks_per_stage, num_units
    return [
        (nb[0], nu, "bottleneck", [64], [C, C2]),
        (nb[1], nu, "basic", [C, C2], [C, C2, C4]),
        (nb[2], nu, "basic", [C, C2, C4], [C, C2, C4, C8]),
        (nb[3], nu, "basic", [C, C2, C4, C8], [C, C2, C4, C8]),
    ]


class HRNetBackbone(nn.Module):
    """4-stage HRNet. Returns per-scale NCHW maps at 1/4..1/32 of the input
    with C..8C channels, or a single 1/4-scale map when
    ``final_stage_single_scale`` is set (pose heads)."""

    def __init__(self, C: int = 32, final_stage_single_scale: bool = False,
                 num_blocks_per_stage: Sequence[int] = (1, 1, 4, 3), num_units: int = 4):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 3, 2, 1, bias=False)
        self.bn1 = batch_norm(64)
        self.conv2 = nn.Conv2d(64, 64, 3, 2, 1, bias=False)
        self.bn2 = batch_norm(64)
        config = stage_configs(C, num_blocks_per_stage, num_units)
        self.stages = nn.ModuleList(
            HighResolutionStage(
                nb, nu, bt, in_ch, out_ch,
                is_final_stage=s == len(config) - 1, is_first_stage=s == 0,
                final_stage_single_scale=final_stage_single_scale,
            )
            for s, (nb, nu, bt, in_ch, out_ch) in enumerate(config)
        )

    def forward(self, x: torch.Tensor) -> list:
        x = torch.relu(self.bn1(self.conv1(x)))
        xs = [torch.relu(self.bn2(self.conv2(x)))]
        for stage in self.stages:
            xs = stage(xs)
        return xs
