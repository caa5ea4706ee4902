"""The readings that set a cell's limits from above: the control (the
reference in the program's place, its products rounded to float8 e4m3, the
precision below the configurations' bfloat16) and, for training, the
reference in the program's place with half of each batch left out (the
mean taken over the rest): ``half_batch`` cuts the inputs, ``half_loss``
runs the whole batch forward and takes the loss over half of its rows,
``half_tag_loss`` (keypoints) the associative-embedding term alone; each
held against the float32 reference on the cell's own sizes and inputs.
And, as a witness of what bfloat16 itself does to the training numbers,
the reference with its products' operands and gradients rounded to
bfloat16.

    python3 -m gpubench.control --workload <cell> --seeds 1,2,3

Prints one JSON line a seed. The benchmark's own runs never run this; the
readings and the limits set from them are in PERF.md. A frames cell's
frames are ``keep_max`` drawn from the seed over its pool.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from gpubench import harness, training
from gpubench.harness import arch_of
from gpubench.reference import train as ref_train
from gpubench.reference.nets import Net, spec
from gpubench.reference.pose import maps
from gpubench.reference.precision import Rounded
from gpubench.traffic import frames
from gpubench.weights import make_weights

CONTROL = ("float8_e4m3", "float8_e5m2")  # forward operands, backward gradients


@torch.no_grad()
def frames_readings(cell: dict, seed: int, device) -> dict:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    p = cell["workload"]["params"]
    arch, hw = arch_of(cell["config"]), (p["height"], p["width"])
    weights = make_weights(spec(arch, hw), seed, device)
    ref, ctl = Net(arch, weights), Net(arch, weights, products=Rounded(*CONTROL))
    pool = frames.make_pool(seed, p)
    rng = np.random.default_rng([seed % 2**63, 2])
    err = 0.0
    for _ in range(p["keep_max"]):
        x = frames.frame(pool, int(rng.integers(p["pool"])), int(rng.integers(p["batch"])), device)
        r_avg, r_tags = maps(ref, x, p["flip"], hw)
        c_avg, c_tags = maps(ctl, x, p["flip"], hw)
        err = max(err, frames.maps_error(c_avg[0], [t[0] for t in c_tags], r_avg[0],
                                         [t[0] for t in r_tags]))
    return {"control": {"fwd_err": err}}


def cut(x):
    """The first half of the rows of a tensor, or of each tensor of a list,
    tuple or dict."""
    if isinstance(x, dict):
        return {k: cut(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(cut(v) for v in x)
    return x[: x.shape[0] // 2]


def half_loss(terms):
    """The loss over the first half of the batch's rows; the forward whole."""
    return lambda out, batch: terms(cut(out), cut(batch))


def half_tag_loss(out, batch: dict) -> dict:
    """The keypoints loss with its push and pull over the first half of the
    batch's rows."""
    t = ref_train.keypoints_terms(out, batch)
    push, pull = ref_train.ae_loss(cut(out[1]), cut(batch["joints"]))
    t.update(push=ref_train.TAG_WEIGHT * push, pull=ref_train.TAG_WEIGHT * pull)
    t["loss"] = sum(v for k, v in t.items() if k != "loss")
    return t


def train_readings(cell: dict, seed: int, device, kind) -> dict:
    p, c = cell["workload"]["params"], cell["config"]
    arch, hw = arch_of(c), (p["size"], p["size"])
    sp, opt = spec(arch, hw), c["optimizer"]
    batches = kind.Cell.make_batches(seed, c, p, device)[:p["check_steps"]]
    ref = training.reference_readings(arch, sp, seed, device, batches, opt)
    terms = ref_train.terms_of(arch)
    variants = {
        "control": {"products": Rounded(*CONTROL)},
        "half_batch": {"batches": [cut(b) for b in batches]},
        "half_loss": {"terms": half_loss(terms)},
        "bf16_reference": {"products": Rounded("bfloat16", "bfloat16")},
    }
    if arch["model"] == "HigherHRNet":
        variants["half_tag_loss"] = {"terms": half_tag_loss}
    out = {}
    for name, v in variants.items():
        r = training.reference_readings(arch, sp, seed, device, v.get("batches", batches), opt,
                                        v.get("products"), v.get("terms"))
        out[name] = training.compare(r, ref)
        out[name]["loss1_terms_err"] = training.terms_err(arch, [t.cpu() for t in r["out"]],
                                                          batches[0], r["terms"])
    return out


def readings(cell: dict, seed: int, device, layout=None) -> dict:
    kind = (layout or harness.Layout()).kind(cell["workload"]["kind"])
    if hasattr(kind.Cell, "make_batches"):
        return train_readings(cell, seed, device, kind)
    return frames_readings(cell, seed, device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m gpubench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("gpubench.control: no CUDA device", file=sys.stderr)
        return 3
    cell = harness.Layout().cell(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        rec = {"workload": args.workload, "seed": seed,
               **readings(cell, seed, torch.device("cuda"))}
        print(json.dumps(rec), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
