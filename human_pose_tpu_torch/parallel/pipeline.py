"""Pipeline parallelism: the HigherHRNet forward cut into segments, one a
device, walked microbatch by microbatch (port of
human_pose_tpu/parallel/pipeline.py).

The model is cut into UNITS at its natural boundaries: ``stem`` (the
backbone's two stride-2 convs), ``stage1`` ... ``stage4`` (the backbone's
stages) and ``head`` (``init_heatmaps_head`` and the deconv head). A unit
runs the model's own code (``HRNetBackbone.stem``, the stages,
``HigherHRNet.head``) on the model's submodules, so the units in order
compute exactly the monolithic forward. A partition groups consecutive units into segments;
segment i holds a copy of its units on ``devices[i]`` (in eval mode, as the
JAX package's pipeline applies ``train=False``), and the activations hop
from device to device with ``.to(device, non_blocking=True)``.

``PipelinedModel.__call__`` walks the microbatches through the segments.
CUDA launches are asynchronous: while segment 0 runs microbatch j + 1 on
its card, segment 1 may run microbatch j on the next one (GPipe's fill and
drain, bubble (S - 1) / (S - 1 + M) for M microbatches). A device may be
named more than once (the CPU in tests, ``cuda:0`` on one card): its
segments then run one after another. Under bfloat16 each segment runs under
``torch.autocast`` on its own device; the head's outputs are float32.

The pipeline is for inference: HigherHRNet-W32 fits on one card, and
training composes the data x space x tensor mesh instead
(``parallel/tensor.py``).
"""

from __future__ import annotations

import contextlib
import copy
from typing import NamedTuple, Sequence

import torch
from torch import nn

from ..models.higher_hrnet import HigherHRNet
from ..models.hrnet import HRNetBackbone

DEFAULT_PARTITION: tuple = (
    ("stem", "stage1", "stage2"),
    ("stage3",),
    ("stage4",),
    ("head",),
)


def partition_for(n_segments: int) -> tuple:
    """Near-balanced groupings of the six units for 1-6 pipeline segments,
    the JAX package's table (from its per-unit times on a v5e: stem 0.45 /
    stage1 0.22 / stage2 0.23 / stage3 1.22 / stage4 1.13 / head 1.0 ms an
    image)."""
    table = {
        1: (("stem", "stage1", "stage2", "stage3", "stage4", "head"),),
        2: (("stem", "stage1", "stage2", "stage3"), ("stage4", "head")),
        3: (("stem", "stage1", "stage2", "stage3"), ("stage4",), ("head",)),
        4: DEFAULT_PARTITION,
        5: (("stem",), ("stage1", "stage2"), ("stage3",), ("stage4",), ("head",)),
        6: (("stem",), ("stage1",), ("stage2",), ("stage3",), ("stage4",), ("head",)),
    }
    if n_segments not in table:
        raise ValueError(f"pipeline supports 1-6 segments (6 model units), got {n_segments}")
    return table[n_segments]


class Unit(NamedTuple):
    name: str
    module: nn.Module  # its forward maps the previous unit's output to this unit's


class _Stem(nn.Module):
    """``HRNetBackbone.stem`` on the backbone's ``conv1``/``bn1``/``conv2``/
    ``bn2``; returns the one-scale list the stages take."""

    def __init__(self, backbone: HRNetBackbone):
        super().__init__()
        self.conv1, self.bn1, self.conv2, self.bn2 = (
            backbone.conv1, backbone.bn1, backbone.conv2, backbone.bn2)

    def forward(self, x: torch.Tensor) -> list:
        return [HRNetBackbone.stem(self, x)]


class _Head(nn.Module):
    """``HigherHRNet.head`` on the model's ``init_heatmaps_head`` and
    ``deconv_layers``: ``([hm_quarter, hm_half], tags)`` in float32."""

    def __init__(self, model: HigherHRNet):
        super().__init__()
        self.num_kpts, self.remat_head = model.num_kpts, model.remat_head
        self.init_heatmaps_head, self.deconv_layers = model.init_heatmaps_head, model.deconv_layers

    def forward(self, xs: list):
        return HigherHRNet.head(self, xs[0])


def build_units(model: nn.Module) -> list[Unit]:
    """Cut a ``HigherHRNet`` into its pipeline units, in forward order.
    The units share the model's parameters."""
    backbone = model.backbone
    units = [Unit("stem", _Stem(backbone))]
    units += [Unit(f"stage{i + 1}", stage) for i, stage in enumerate(backbone.stages)]
    units.append(Unit("head", _Head(model)))
    return units


def tree_to(tree, device: torch.device):
    """``tree`` (a tensor, or lists and tuples of them) on ``device``."""
    if torch.is_tensor(tree):
        return tree.to(device, non_blocking=True)
    return type(tree)(tree_to(t, device) for t in tree)


def _cat(parts: list):
    first = parts[0]
    if torch.is_tensor(first):
        return torch.cat(parts)
    return type(first)(_cat(list(p)) for p in zip(*parts))


def cuda_devices(n: int) -> list[torch.device]:
    """``cuda:0`` ... ``cuda:n-1``; raises when fewer cards are present (the
    pipeline never falls back to fewer segments or to the CPU)."""
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < n:
        raise RuntimeError(f"a {n}-segment pipeline on the card needs {n} CUDA devices, "
                           f"torch.cuda.device_count() is {have}; pass the CPU explicitly to "
                           "run it there")
    return [torch.device("cuda", i) for i in range(n)]


class PipelinedModel:
    """``HigherHRNet``'s eval forward split over ``len(partition)`` devices,
    microbatched. ``pipe(images, microbatch_size=m)`` returns what
    ``model(images)`` returns in eval mode; segment i's units live on
    ``devices[i]`` (default ``cuda:0`` ... ``cuda:S-1``). ``dtype``
    bfloat16 runs each segment under ``torch.autocast`` on its device."""

    def __init__(self, model: nn.Module, partition: Sequence[Sequence[str]] = DEFAULT_PARTITION,
                 devices: Sequence | None = None, dtype: torch.dtype = torch.float32):
        if devices is None:
            devices = cuda_devices(len(partition))
        if len(devices) < len(partition):
            raise ValueError(f"partition has {len(partition)} segments but only "
                             f"{len(devices)} devices were given")
        if dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"dtype must be float32 or bfloat16, got {dtype}")
        units = {u.name: u for u in build_units(model)}
        unknown = [n for seg in partition for n in seg if n not in units]
        if unknown:
            raise ValueError(f"unknown units {unknown}; have {sorted(units)}")
        self.dtype = dtype
        self.devices = [torch.device(d) for d in devices[:len(partition)]]
        self.segments = []
        for names, dev in zip(partition, self.devices):
            seg = nn.Sequential(*(copy.deepcopy(units[n].module) for n in names)).to(dev).eval()
            self.segments.append((seg, dev))

    def _compute(self, dev: torch.device):
        if self.dtype == torch.float32:
            return contextlib.nullcontext()
        return torch.autocast(dev.type, dtype=self.dtype)

    @torch.no_grad()
    def __call__(self, images: torch.Tensor, microbatch_size: int | None = None):
        n = images.shape[0]
        m = microbatch_size or n
        if n % m:
            raise ValueError(f"batch {n} not divisible by microbatch {m}")
        outs = []
        for j in range(0, n, m):
            h = images[j:j + m]
            for seg, dev in self.segments:
                h = tree_to(h, dev)
                with self._compute(dev):
                    h = seg(h)
            outs.append(h)
        return outs[0] if len(outs) == 1 else _cat(outs)
