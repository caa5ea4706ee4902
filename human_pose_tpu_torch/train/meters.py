"""Streaming metric averages (port of human_pose_tpu/train/meters.py).

Counterpart of reference src/base/meters.py. The reference's
``AverageMeter.all_reduce`` (NCCL SUM of [sum, count]) is not needed while
the port trains in one process: a step's metrics are already the batch's
means, so host-side running averages suffice.
"""

from __future__ import annotations


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

    def to_dict(self) -> dict[str, float]:
        return {name: m.avg for name, m in self.meters.items()}
