"""A copy of the benchmark's cells at sizes a CPU test can hold: the same
files and limits, the networks at width 8 with one unit a stage, a few
small frames or images a batch, the program in float32. Not a test file."""

from __future__ import annotations

import json
from pathlib import Path

from gpubench import harness

CELLS = ("pose_w32_infer_bs32", "pose_w32_train_bs36", "cls_w32_train_bs80", "pose_w32_flip_bs16")


def write(root: Path) -> harness.Layout:
    """The tiny copy under ``root``; a layout that finds it first."""
    bench = harness.load_json(harness.HERE.parent / "BENCHMARK.json")
    (root / "configs").mkdir(parents=True, exist_ok=True)
    (root / "workloads").mkdir(exist_ok=True)
    for c in bench["configs"]:
        cfg = harness.load_json(harness.HERE / "configs" / f"{c['name']}.json")
        cfg.update(C=8, num_blocks_per_stage=[1, 1, 1, 1], num_units=1, precision="float32")
        if cfg["model"] == "HigherHRNet":
            cfg["num_deconv_resid_blocks"] = 1
        else:  # ten classes at lr 0.1 make three steps chaotic at this size
            cfg.update(num_classes=10, optimizer={**cfg["optimizer"], "lr": 0.01})
        (root / "configs" / f"{c['name']}.json").write_text(json.dumps(cfg))
    for name in CELLS:
        w = harness.load_json(harness.HERE / "workloads" / f"{name}.json")
        if w["kind"] == "frames":
            w["params"].update(batch=2, height=64, width=128, pool=2, keep_every=1, keep_max=2,
                               trace_units=2)
        else:
            w["params"].update(batch=4, size=64, pool=4, trace_units=2)
        (root / "workloads" / f"{name}.json").write_text(json.dumps(w))
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return harness.Layout(roots=(root, harness.HERE), benchmark=root / "BENCHMARK.json")
