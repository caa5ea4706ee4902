"""Finding a cell's parts by name, and one run of a cell.

A cell of ``BENCHMARK.json`` names a configuration and a traffic mix. The
harness finds, by those names:

* ``configs/<config>.json``: the model, its widths, input size, precision
  and source;
* ``workloads/<cell>.json``: the cell's traffic mix (its ``kind`` and that
  kind's parameters) and the limits of its correctness check;
* ``traffic/<kind>.py``: the generator of that kind of traffic, a module
  with ``Cell(ctx)`` (see ``traffic/__init__.py``);
* ``layer_metrics/<metric>.py``: for each per-layer metric of the cell, a
  reader ``read(ctx) -> float | None``.

A later configuration, cell or per-layer metric is new files and new
entries in ``BENCHMARK.json``; no file here changes.
"""

from __future__ import annotations

import importlib.util
import json
import math
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "human_pose_tpu")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    """The module at ``path`` (a file whose name may hold dots), imported
    under ``name``."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@dataclass
class Layout:
    """Where the harness looks for a cell's parts: ``BENCHMARK.json`` and the
    folders that hold ``configs/``, ``workloads/``, ``traffic/`` and
    ``layer_metrics/``, searched in order (the benchmark's own folder by
    default)."""

    roots: tuple = (HERE,)
    benchmark: Path = HERE.parent / "BENCHMARK.json"

    def find(self, *parts: str) -> Path:
        for root in self.roots:
            path = Path(root, *parts)
            if path.exists():
                return path
        raise FileNotFoundError("/".join(parts) + f" under none of {[str(r) for r in self.roots]}")

    def cell(self, name: str) -> dict:
        """Everything the run of cell ``name`` needs: its entry, its
        configuration, its workload file and its metrics of both kinds."""
        bench = load_json(self.benchmark)
        entries = {w["name"]: w for w in bench["workloads"]}
        if name not in entries:
            raise KeyError(f"no cell {name!r} in {self.benchmark}")
        entry = entries[name]
        workload = load_json(self.find("workloads", f"{name}.json"))
        for key in ("config", "traffic"):
            if workload[key] != entry[key]:
                raise ValueError(f"{name}: workloads/{name}.json has {key} {workload[key]!r}, "
                                 f"BENCHMARK.json {entry[key]!r}")

        def applies(metric):
            return "workloads" not in metric or name in metric["workloads"]

        return {
            "entry": entry,
            "config": load_json(self.find("configs", f"{entry['config']}.json")),
            "workload": workload,
            "end_to_end": [m for m in bench["end_to_end"] if applies(m)],
            "per_layer": [m for m in bench["per_layer"] if applies(m)],
        }

    def kind(self, kind: str):
        return load_module(self.find("traffic", f"{kind}.py"), f"gpubench_traffic_{kind}")

    def reader(self, metric: str):
        return load_module(self.find("layer_metrics", f"{metric}.py"),
                           "gpubench_metric_" + metric.replace(".", "_").replace("-", "_"))


@dataclass
class Context:
    """What a cell's traffic and the per-layer readers share in one run."""

    cell: dict
    seed: int
    seconds: float
    device: object
    config: dict = field(default_factory=dict)
    params: dict = field(default_factory=dict)
    limits: dict = field(default_factory=dict)
    # filled as the run goes: the window's units, latencies and seconds,
    # the trace, and counts a kind reports for the readers
    window_s: float = 0.0
    units: int = 0
    latencies_s: list = field(default_factory=list)
    trace: object = None
    extra: dict = field(default_factory=dict)

    @classmethod
    def make(cls, cell: dict, seed: int, seconds: float, device) -> "Context":
        w = cell["workload"]
        return cls(cell=cell, seed=seed, seconds=seconds, device=device, config=cell["config"],
                   params=w["params"], limits=w["limits"])


class Laps:
    """Seconds between named points of a set-up, reported on standard error."""

    def __init__(self):
        self.t = time.perf_counter()

    def __call__(self, label: str) -> None:
        now = time.perf_counter()
        print(f"set-up lap {label}: {now - self.t:.3f} s", file=sys.stderr)
        self.t = now


def arch_of(config: dict) -> dict:
    """A configuration's architecture: the keys the networks are built from."""
    keys = ("model", "C", "num_kpts", "num_classes", "num_blocks_per_stage", "num_units",
            "num_deconv_resid_blocks")
    return {k: config[k] for k in keys if k in config}


def p95(values: list) -> float:
    """The 95th percentile (linear between order statistics)."""
    v = sorted(values)
    pos = 0.95 * (len(v) - 1)
    lo = math.floor(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


def forbidden_modules() -> list:
    """Modules of JAX, flax or the JAX package in this process, by whole
    top-level name (``human_pose_tpu_torch`` is not ``human_pose_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def run_window(cell, ctx: Context) -> None:
    """Run the cell's units back to back for ``ctx.seconds`` seconds. A
    unit that returns a latency (seconds, host clock) adds it to the tail;
    ``cell.drain()`` ends the window once the host has stopped issuing."""
    t0 = time.perf_counter()
    n = 0
    while True:
        lat = cell.unit(n)
        n += 1
        if lat is not None:
            ctx.latencies_s.append(lat)
        if time.perf_counter() - t0 >= ctx.seconds:
            break
    cell.drain()
    ctx.window_s = time.perf_counter() - t0
    ctx.units = n


def judge(checks: list) -> bool:
    """Every compared number finite and within its limit."""
    return bool(checks) and all(math.isfinite(v) and v <= lim for _, v, lim in checks)

