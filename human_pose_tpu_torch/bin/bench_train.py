"""Training-step throughput benchmark (port of human_pose_tpu/bin/bench_train.py).

Measures a full train step (forward, loss, backward, optimizer update) at
the reference's training shapes on the card, in bfloat16 autocast with
float32 parameters and optimizer state:

* keypoints (default): HigherHRNet-W32, heatmap MSE + AE push/pull, Adam,
  bs 36 @ 512 (experiments/keypoints/higher_hrnet_32.yaml)
* classification: ClassificationHRNet-W32, cross entropy, SGD momentum 0.9
  nesterov, weight decay 1e-4, bs 80 @ 224
  (experiments/classification/hrnet_32.yaml)

    python -m human_pose_tpu_torch.bin.bench_train [--task=keypoints|classification]
        [--batch=N] [--size=N] [--iters=N] [--remat=false|true|0,4] [--C=32]
        [--device=cuda]  # --device=cpu runs the plain PyTorch path

Weights from ``init_flax_default_`` (seed 0). Each step takes a batch
synthesized on the device (``synth_batch``: the JAX package's ramps, built
in its NHWC order and permuted to NCHW), distinct per iteration, so no
loader is timed. ``iters`` steps run once to warm up (cuDNN's plans, the
allocator), then ``iters`` more, timed from the host to the one fetch of
the last loss: the printed loss is the loss after ``2 * iters`` steps.

Under ``torch.distributed.run`` each process joins the group
(``parallel.setup_distributed``: NCCL on ``cuda:LOCAL_RANK``, gloo with
``--device=cpu``) and, at world size > 1, steps data-parallel on its rows
of the global ``--batch`` through the data ``Mesh``; rank 0 prints.

Prints one JSON line: {"metric", "value" (images a second), "unit",
"ms_per_step", "loss", "platform"}.
"""

from __future__ import annotations

import json
import math
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from ..device import resolve_device
from ..models import ClassificationHRNet, HigherHRNet, init_flax_default_
from ..parallel.distributed import finalize_distributed, setup_distributed
from ..parallel.mesh import make_mesh
from ..train.optim import create_optimizer
from ..train.state import TrainState
from ..train.steps import classification_train_step, keypoints_train_step
from ..utils.argv import parse_flags

K, P = 17, 30  # joints, person slots of the synthesized joints
# task -> (batch, size, iters, remat)
DEFAULTS = {"keypoints": (36, 512, 5, False), "classification": (80, 224, 10, False)}
LR = {"keypoints": 1e-3, "classification": 0.1}
OPTIMIZER = {"keypoints": ("Adam", {}),
             "classification": ("SGD", {"momentum": 0.9, "weight_decay": 1e-4, "nesterov": True})}


def parse_remat(value: str) -> bool | tuple:
    """``true``/``false``, or comma-separated stage indices (``0,4``)."""
    v = value.lower()
    if v in ("true", "false"):
        return v == "true"
    return tuple(int(s) for s in v.split(",") if s)


def ramp(shape: tuple, i: int, device, rows: tuple | None = None) -> torch.Tensor:
    """The JAX package's ramp ``arange(n) * (1.0 / n) + float32(i) *
    float32(1e-3)`` in float32 over the NHWC ``shape`` (``n`` its size),
    row-major, then permuted to NCHW. ``rows`` ``(lo, hi)`` gives only
    those rows of dim 0."""
    n = math.prod(shape)
    lo, hi = rows or (0, shape[0])
    per_row = n // shape[0]
    idx = torch.arange(lo * per_row, hi * per_row, dtype=torch.int64, device=device)
    offset = float(np.float32(i) * np.float32(1e-3))
    flat = idx.to(torch.float32) * (1.0 / n) + offset
    return flat.reshape(hi - lo, *shape[1:]).permute(0, 3, 1, 2).contiguous()


def synth_images(i: int, batch: int, size: int, device, rows: tuple | None = None) -> torch.Tensor:
    """Iteration ``i``'s float images ``[N, 3, size, size]``."""
    return ramp((batch, size, size, 3), i, device, rows)


def synth_labels(i: int, batch: int, device, rows: tuple | None = None) -> torch.Tensor:
    """Iteration ``i``'s classification labels ``(arange(batch) + i) % 1000``."""
    lo, hi = rows or (0, batch)
    return (torch.arange(lo, hi, device=device) + i) % 1000


def synth_batch(i: int, batch: int, size: int, device, rows: tuple | None = None) -> dict:
    """Iteration ``i``'s keypoints batch (``train/steps.py``'s layout):
    images and heatmaps at 1/4 and 1/2 as ramps, masks of ones, joints
    ``[N, P, K, 3]`` of ones. ``rows`` ``(lo, hi)`` takes those images of
    the global batch."""
    lo, hi = rows or (0, batch)
    quarter, half = size // 4, size // 2
    return {
        "images": synth_images(i, batch, size, device, rows),
        "heatmaps": [ramp((batch, quarter, quarter, K), i, device, rows),
                     ramp((batch, half, half, K), i, device, rows)],
        "masks": [torch.ones((hi - lo, quarter, quarter), device=device),
                  torch.ones((hi - lo, half, half), device=device)],
        "joints": torch.ones((hi - lo, P, K, 3), dtype=torch.int32, device=device),
    }


def create_state(task: str, width: int, remat, device, mesh=None) -> TrainState:
    """The task's model (seeded flax default init) and optimizer in a
    bfloat16 ``TrainState`` on ``device``."""
    if task == "keypoints":
        model = HigherHRNet(num_kpts=K, C=width, remat=remat, device=device)
    else:
        model = ClassificationHRNet(num_classes=1000, C=32, remat=bool(remat), device=device)
    init_flax_default_(model, torch.Generator().manual_seed(0))
    name, params = OPTIMIZER[task]
    optimizer = create_optimizer(model.parameters(), name, lr=LR[task], **params)
    return TrainState.create(model, optimizer, dtype=torch.bfloat16, device=device, mesh=mesh)


def run_steps(state: TrainState, task: str, iters: int, batch: int, size: int,
              rows: tuple | None = None) -> torch.Tensor:
    """``iters`` steps on synthesized batches ``0..iters-1`` at a constant
    learning rate; returns the last step's loss (on the device)."""
    loss = None
    for i in range(iters):
        if task == "keypoints":
            _, metrics = keypoints_train_step(
                state, synth_batch(i, batch, size, state.device, rows), LR[task])
        else:
            _, metrics = classification_train_step(
                state, synth_images(i, batch, size, state.device, rows),
                synth_labels(i, batch, state.device, rows), LR[task])
        loss = metrics["loss"]
    return loss


def main(argv: list[str] | None = None) -> dict:
    """Run the benchmark on ``argv`` (default ``sys.argv[1:]``); prints
    (rank 0) and returns its record."""
    args, _ = parse_flags(
        sys.argv[1:] if argv is None else list(argv),
        {"task": "keypoints", "batch": None, "size": None, "iters": None, "remat": None,
         "C": 32, "device": "cuda"},
    )
    task = args["task"]
    if task not in DEFAULTS:
        raise SystemExit(f"--task={task!r}: keypoints or classification")
    batch, size, iters, remat = DEFAULTS[task]
    batch = batch if args["batch"] is None else int(args["batch"])
    size = size if args["size"] is None else int(args["size"])
    iters = iters if args["iters"] is None else int(args["iters"])
    remat = remat if args["remat"] is None else parse_remat(args["remat"])
    if iters < 1:
        raise SystemExit("--iters must be at least 1")
    device = resolve_device(args["device"])

    rank = setup_distributed(device.type)
    try:
        world = dist.get_world_size() if dist.is_initialized() else 1
        mesh, rows = None, None
        if world > 1:
            if batch % world:
                raise SystemExit(f"--batch={batch} does not split over {world} processes")
            mesh = make_mesh()
            device = mesh.device
            local = batch // world
            rows = (rank * local, (rank + 1) * local)
        state = create_state(task, args["C"], remat, device, mesh)
        float(run_steps(state, task, iters, batch, size, rows))  # warm-up
        t0 = time.perf_counter()
        loss = float(run_steps(state, task, iters, batch, size, rows))
        dt = time.perf_counter() - t0
        net = f"HigherHRNet-W{args['C']}" if task == "keypoints" else "ClassificationHRNet-W32"
        record = {
            "metric": "train images/sec %s @%d (bs %d, %d devices)" % (net, size, batch, world),
            "value": batch * iters / dt,
            "unit": "images/sec",
            "ms_per_step": 1000 * dt / iters,
            "loss": loss,
            "platform": "gpu" if device.type == "cuda" else "cpu",
        }
        if rank == 0:
            print(json.dumps(record), flush=True)
        return record
    finally:
        finalize_distributed()


if __name__ == "__main__":
    main()
