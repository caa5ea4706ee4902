"""The top-down training cells' reference readings and their controls:
``training.py`` and ``control.py`` for ``reference/sppe.py``'s net, whose
spec, steps and loss those two do not dispatch to.

``reference_readings`` recomputes a cell's first steps in float32 (TF32
off, the stem and stages recomputed in the backward so that the cell's
batch fits beside the pool); ``terms_err`` works out the loss terms again
on the program's own first output. The comparison itself is
``training.compare``.

    python3 -m gpubench.topdown --workload <cell> --seeds 1,2,3

prints one JSON line a seed: the float8 control (e4m3 forward, e5m2
backward), ``half_batch`` (the inputs cut to their first half),
``half_loss`` (the forward whole, the loss over the first half of the
rows) and the bfloat16 witness, each held against the float32 reference
on the cell's own sizes and inputs, as ``control.py`` does for the other
training cells. The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import math
import sys

import torch

from gpubench import harness, training
from gpubench.control import CONTROL, cut, half_loss
from gpubench.harness import arch_of
from gpubench.reference.precision import Rounded
from gpubench.reference.train import make_optimizer
from gpubench.reference.sppe import joints_mse_terms, spec, train_steps
from gpubench.weights import make_weights


def input_hw(params: dict) -> tuple:
    return params["height"], params["width"]


def reference_readings(arch: dict, spec_: list, seed: int, device, batches: list,
                       optimizer: dict, products=None, terms=None) -> dict:
    """``training.reference_readings`` for the top-down net."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    state = make_weights(spec_, seed, device)
    out = train_steps(arch, state, batches, make_optimizer(optimizer), products, terms,
                      recompute=True)
    start = make_weights(spec_, seed, device)
    with torch.no_grad():
        change = {k: float((state[k] - start[k]).norm()) for k, t in start.items()
                  if t.is_floating_point()}
    return {"loss": out["loss"], "terms": out["terms"],
            "grad": {k: float(g.norm()) for k, g in out["first_gradient"].items()},
            "change": change, "out": out["out"],
            "moments": list(next(iter(out["stats"].values())))}


@torch.no_grad()
def terms_err(out: list, batch: dict, reported: dict) -> float:
    """``training.terms_err`` for the joints MSE: the terms a step reported
    for its first batch against ``joints_mse_terms`` of that step's own
    output ``out`` and the batch."""
    dev, n = batch["images"].device, batch["images"].shape[0]
    if any(t.shape[0] != n for t in out):  # not an output of this batch
        return math.inf
    ref = joints_mse_terms([t.to(dev) for t in out], batch)
    floor = 1e-6 * abs(float(ref["loss"]))
    return max(abs(float(reported[k]) - float(v)) / max(abs(float(v)), floor, 1e-30)
               if k in reported else math.inf for k, v in ref.items())


def control_readings(cell: dict, seed: int, device, layout=None) -> dict:
    """The control, the faults and the witness of a top-down cell at
    ``seed``, each as ``training.compare`` reads it against the reference,
    with ``loss1_terms_err``."""
    kind = (layout or harness.Layout()).kind(cell["workload"]["kind"])
    p, c = cell["workload"]["params"], cell["config"]
    arch = arch_of(c)
    sp, opt = spec(arch, input_hw(p)), c["optimizer"]
    batches = kind.Cell.make_batches(seed, c, p, device)[:p["check_steps"]]
    ref = reference_readings(arch, sp, seed, device, batches, opt)
    variants = {
        "control": {"products": Rounded(*CONTROL)},
        "half_batch": {"batches": [cut(b) for b in batches]},
        "half_loss": {"terms": half_loss(joints_mse_terms)},
        "bf16_reference": {"products": Rounded("bfloat16", "bfloat16")},
    }
    out = {}
    for name, v in variants.items():
        r = reference_readings(arch, sp, seed, device, v.get("batches", batches), opt,
                               v.get("products"), v.get("terms"))
        out[name] = training.compare(r, ref)
        out[name]["loss1_terms_err"] = terms_err([t.cpu() for t in r["out"]], batches[0],
                                                 r["terms"])
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m gpubench.topdown")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("gpubench.topdown: no CUDA device", file=sys.stderr)
        return 3
    cell = harness.Layout().cell(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        rec = {"workload": args.workload, "seed": seed,
               **control_readings(cell, seed, torch.device("cuda"))}
        print(json.dumps(rec), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
