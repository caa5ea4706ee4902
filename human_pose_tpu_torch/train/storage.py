"""Metric history storage (port of human_pose_tpu/train/storage.py).

Counterpart of reference src/base/storage.py: nested
{metric: {split: [{step, epoch, value}]}} store with group-by-mean aggregation
over "epoch" or "step", plus a time-series store for system monitoring.
"""

from __future__ import annotations

from collections import defaultdict


class MetricsStorage:
    def __init__(self, name: str = "metrics"):
        self.name = name
        self.metrics: dict[str, dict[str, list[dict]]] = {}

    def append(self, metrics: dict[str, float], step: int, epoch: int, split: str) -> None:
        for name, value in metrics.items():
            splits = self.metrics.setdefault(name, {})
            splits.setdefault(split, []).append(
                {"step": int(step), "epoch": int(epoch), "value": float(value)}
            )

    def aggregate_over_key(self, key: str = "epoch") -> "MetricsStorage":
        """Group-by-mean over 'epoch' or 'step' (reference storage.py:38-55)."""
        agg = MetricsStorage(f"{self.name}_per_{key}")
        for name, splits in self.metrics.items():
            for split, records in splits.items():
                grouped: dict[int, list[float]] = defaultdict(list)
                keys: dict[int, dict] = {}
                for r in records:
                    grouped[r[key]].append(r["value"])
                    keys[r[key]] = r
                for k in sorted(grouped):
                    rec = dict(keys[k])
                    rec["value"] = sum(grouped[k]) / len(grouped[k])
                    agg.metrics.setdefault(name, {}).setdefault(split, []).append(rec)
        return agg

    def to_dict(self) -> dict:
        return self.metrics

    def state_dict(self) -> dict:
        return {"metrics": self.metrics}

    def load_state_dict(self, state: dict) -> None:
        self.metrics = state["metrics"]


class SystemMonitoringStorage:
    """Time series of system samples (reference storage.py:95-103)."""

    def __init__(self):
        self.samples: list[dict] = []

    def append(self, sample: dict) -> None:
        self.samples.append(sample)

    def to_dict(self) -> dict[str, list]:
        out: dict[str, list] = defaultdict(list)
        for s in self.samples:
            for k, v in s.items():
                out[k].append(v)
        return dict(out)
