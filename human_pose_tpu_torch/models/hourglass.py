"""Stacked Hourglass networks with intermediate supervision, NCHW (port of
human_pose_tpu/models/hourglass.py; counterpart of reference
src/keypoints/architectures/hourglass.py).

4-level encoder/decoder hourglass modules stacked ``num_stages`` times; each
stage has a head producing heatmaps (+ AE tags for the multi-person
variant) that are remapped and added back into the trunk. Stem: 7x7 s2
conv -> residual -> maxpool -> residuals (a 1/4-resolution trunk at 256
channels). Heatmaps and tags are float32 whatever the compute dtype.

Submodules carry the JAX model's names (``trunk.stem``,
``trunk.layer{0,1,2}``, ``trunk.hg{i}.res{j}`` / ``.down{j}`` / ``.mid`` /
``.up{j}``, ``trunk.head{i}.res`` / ``.cba`` / ``.heatmaps`` /
``.remap_feats`` / ``.remap_heatmaps`` / ``.tags``; ``cba{1,2,3}`` and
``proj`` in a residual module, ``conv`` and ``bn`` in a ``ConvBnAct``), so
the weights bridge maps a flax path to its key by joining it with dots.

In train mode every BatchNorm (each ``ConvBnAct``'s ``bn``) is the port's
flax-statistics ``BatchNorm2d`` (the config's ``create_net`` gives it the
run's statistics scope, ``models/norm.py::convert_batch_norm``). The AE
hourglass trains through ``train/steps.py`` as HigherHRNet does, with every
heatmap target at 1/4 (``hm_resolutions [0.25, 0.25]`` for two stages).
"""

from __future__ import annotations

import torch
from torch import nn

from ..device import resolve_device
from .helpers import ConvBnAct, max_pool_2x2, upsample_nearest_2x


class ResidualModule(nn.Module):
    """1x1 -> 3x3 -> 1x1 bottleneck with expansion 2 (reference
    hourglass.py:6-28); a 1x1 projection only when the width changes."""

    def __init__(self, cin: int, mid: int, expansion: int = 2):
        super().__init__()
        out_ch = mid * expansion
        self.cba1 = ConvBnAct(cin, mid, 1)
        self.cba2 = ConvBnAct(mid, mid, 3)
        self.cba3 = ConvBnAct(mid, out_ch, 1, activation=None)
        self.proj = None if cin == out_ch else ConvBnAct(cin, out_ch, 1, activation=None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.cba3(self.cba2(self.cba1(x)))
        residual = x if self.proj is None else self.proj(x)
        return torch.relu(out + residual)


class HourglassModule(nn.Module):
    """Recursive encoder/decoder (reference hourglass.py:31-81) on
    ``channels``-wide input; every residual module outputs ``2 * mid``."""

    def __init__(self, channels: int = 256, num_blocks: int = 4, mid: int = 128):
        super().__init__()
        self.num_blocks = num_blocks
        c = channels
        for i in range(num_blocks):
            self.add_module(f"res{i}", ResidualModule(c, mid))
            self.add_module(f"down{i}", ResidualModule(c, mid))
            c = 2 * mid
        self.mid = ResidualModule(c, mid)
        for i in range(num_blocks):
            self.add_module(f"up{i}", ResidualModule(2 * mid, mid))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        residuals = []
        for i in range(self.num_blocks):
            residuals.append(getattr(self, f"res{i}")(x))
            x = getattr(self, f"down{i}")(max_pool_2x2(x))
        x = self.mid(x)
        for i in range(self.num_blocks):
            x = upsample_nearest_2x(getattr(self, f"up{i}")(x)) + residuals[-(i + 1)]
        return x


class _HourglassStageHead(nn.Module):
    """Stage head (reference hourglass.py:84-128): residual + 1x1 trunk
    conv, heatmap (and optional tag) 1x1 heads, remap convs for
    reinjection."""

    def __init__(self, channels: int, mid: int, num_kpts: int, with_tags: bool = False):
        super().__init__()
        self.res = ResidualModule(channels, mid)
        self.cba = ConvBnAct(2 * mid, channels, 1)
        self.heatmaps = nn.Conv2d(channels, num_kpts, 1)
        self.remap_feats = nn.Conv2d(channels, channels, 1)
        self.remap_heatmaps = nn.Conv2d(num_kpts, channels, 1)
        self.tags = nn.Conv2d(channels, num_kpts, 1) if with_tags else None

    def forward(self, hg_out: torch.Tensor):
        feats = self.cba(self.res(hg_out))
        heatmaps = self.heatmaps(feats)
        tags = None if self.tags is None else self.tags(feats)
        return self.remap_feats(feats), heatmaps, tags, self.remap_heatmaps(heatmaps)


class _BaseHourglassNet(nn.Module):
    def __init__(self, num_kpts: int = 17, num_stages: int = 2, with_tags: bool = False):
        super().__init__()
        self.num_stages = num_stages
        self.stem = ConvBnAct(3, 64, 7, stride=2)
        self.layer0 = ResidualModule(64, 64)  # -> 128
        self.layer1 = ResidualModule(128, 128)  # -> 256
        self.layer2 = ResidualModule(256, 128)  # -> 256
        for i in range(num_stages):
            self.add_module(f"hg{i}", HourglassModule(256, 4, 128))
            self.add_module(f"head{i}", _HourglassStageHead(256, 128, num_kpts, with_tags))

    def forward(self, images: torch.Tensor):
        x = self.layer0(self.stem(images))
        x = self.layer2(self.layer1(max_pool_2x2(x)))
        stages_hms, stages_tags = [], []
        for i in range(self.num_stages):
            residual = x
            hg = getattr(self, f"hg{i}")(x)
            remap_feats, hms, tags, remap_hms = getattr(self, f"head{i}")(hg)
            stages_hms.append(hms.float())
            if tags is not None:
                stages_tags.append(tags.float())
            x = residual + remap_feats + remap_hms
        return stages_hms, stages_tags


class HourglassNet(nn.Module):
    """SPPE stacked hourglass (reference hourglass.py:185-203): the list of
    heatmap stages. Built on ``device`` (default ``"cuda"``: raises when no
    card is present)."""

    def __init__(self, num_kpts: int = 17, num_stages: int = 2,
                 device: str | torch.device = "cuda"):
        super().__init__()
        dev = resolve_device(device)
        self.trunk = _BaseHourglassNet(num_kpts, num_stages, with_tags=False)
        self.to(dev)

    def forward(self, images: torch.Tensor) -> list:
        return self.trunk(images)[0]


class AEHourglassNet(nn.Module):
    """Bottom-up AE hourglass (reference hourglass.py:206-228): returns
    (heatmap stages, tags of the LAST stage), all at 1/4 resolution, the
    output structure of ``HigherHRNet`` that the AE decode takes. Built on
    ``device`` (default ``"cuda"``: raises when no card is present)."""

    def __init__(self, num_kpts: int = 17, num_stages: int = 2,
                 device: str | torch.device = "cuda"):
        super().__init__()
        dev = resolve_device(device)
        self.trunk = _BaseHourglassNet(num_kpts, num_stages, with_tags=True)
        self.to(dev)

    def forward(self, images: torch.Tensor):
        hms, tags = self.trunk(images)
        return hms, tags[-1]
