"""Streaming metric averages (port of human_pose_tpu/train/meters.py).

Counterpart of reference src/base/meters.py. A data-parallel train step's
metrics are already averaged over the processes (``train/steps.py``); the
validation meters are combined after an evaluate with ``all_reduce`` (the
reference's: a SUM of [sum, count] over the processes), so every process
holds the global averages.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


class AverageMeter:
    def __init__(self, name: str):
        self.name = name
        self.reset()

    def reset(self) -> None:
        self.val = 0.0
        self.sum = 0.0
        self.count = 0

    @property
    def avg(self) -> float:
        return self.sum / self.count if self.count else 0.0

    def update(self, value: float, n: int = 1) -> None:
        self.val = float(value)
        self.sum += float(value) * n
        self.count += n

    def all_reduce(self, mesh) -> None:
        """Sum ``sum`` and ``count`` over the processes of ``mesh`` (a
        ``parallel.Mesh``), in float64 on its device."""
        both = torch.tensor([self.sum, float(self.count)], dtype=torch.float64, device=mesh.device)
        dist.all_reduce(both, group=mesh.group)
        self.sum, self.count = float(both[0]), int(both[1])


class Meters:
    def __init__(self):
        self.meters: dict[str, AverageMeter] = {}

    def update(self, metrics: dict, n: int = 1) -> None:
        for name, value in metrics.items():
            if name not in self.meters:
                self.meters[name] = AverageMeter(name)
            self.meters[name].update(float(value), n)

    def reset(self) -> None:
        for m in self.meters.values():
            m.reset()

    def all_reduce(self, mesh) -> None:
        """``AverageMeter.all_reduce`` of every meter over ``mesh``, in name
        order (every process holds the same names)."""
        for name in sorted(self.meters):
            self.meters[name].all_reduce(mesh)

    def to_dict(self) -> dict[str, float]:
        return {name: m.avg for name, m in self.meters.items()}
