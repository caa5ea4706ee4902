"""The multi-device dry run (port of ``__graft_entry__.dryrun_multichip``):
the three parallel strategies of the JAX package, each held to one
process's monolithic computation, on CPU processes.

``dryrun_multichip(n)`` launches ``n`` gloo processes (torchrun's
variables, a free port on 127.0.0.1) with the shallow C=8 HigherHRNet at
64x64 and a global batch of ``2 n`` images, and checks, as the JAX entry:

1. one Adam step of the n-way data-parallel mesh (global-batch BatchNorm)
   against the monolithic step: |loss difference| < 3e-5 * max(1, |loss|);
2. the same step on the (data, space, model) mesh of JAX's dims rule
   ((n/4, 2, 2) for n >= 8 divisible by 4, (n/2, 2, 1) for even n >= 4),
   same bound;
3. for n >= 4, the 4-segment inference pipeline (``DEFAULT_PARTITION``,
   the CPU as each segment's device) against the monolithic eval forward:
   max error of the 1/2-resolution heatmaps < 1e-4.

Each check prints its "ok" line; a miss raises.

    python -c "from human_pose_tpu_torch.parallel.dryrun import dryrun_multichip; dryrun_multichip(8)"
"""

from __future__ import annotations

import tempfile
from pathlib import Path

import numpy as np
import torch

from .distributed import launch_local

LR = 1e-3
SIZE = 64
K, PERSONS = 17, 30
NET = {"num_kpts": K, "C": 8, "num_blocks_per_stage": (1, 1, 1, 1), "num_units": 1,
       "num_deconv_resid_blocks": 1}


def mesh_dims(n: int) -> tuple | None:
    """The JAX entry's 3-D mesh for ``n`` devices: (n/4, 2, 2), (n/2, 2, 1)
    or none."""
    if n % 4 == 0 and n >= 8:
        return n // 4, 2, 2
    if n % 2 == 0 and n >= 4:
        return n // 2, 2, 1
    return None


def dryrun_batch(n: int) -> dict:
    """The JAX entry's global batch of ``n`` images (its ``RandomState(0)``
    draws, in order), NCHW."""
    rs = np.random.RandomState(0)
    images = rs.rand(n, SIZE, SIZE, 3).astype(np.float32)
    heatmaps = [rs.rand(n, SIZE // 4, SIZE // 4, K).astype(np.float32),
                rs.rand(n, SIZE // 2, SIZE // 2, K).astype(np.float32)]
    masks = [np.ones((n, SIZE // 4, SIZE // 4), np.float32),
             np.ones((n, SIZE // 2, SIZE // 2), np.float32)]
    joints = np.stack([np.stack([rs.randint(0, SIZE // 4, (PERSONS, K)),
                                 rs.randint(0, SIZE // 4, (PERSONS, K)),
                                 (rs.rand(PERSONS, K) > 0.5).astype(np.int64)], axis=-1)
                       for _ in range(n)]).astype(np.int32)
    nchw = lambda a: torch.from_numpy(a.transpose(0, 3, 1, 2).copy())  # noqa: E731
    return {"images": nchw(images), "heatmaps": [nchw(h) for h in heatmaps],
            "masks": [torch.from_numpy(m) for m in masks], "joints": torch.from_numpy(joints)}


def dryrun_net():
    """The shallow net on the CPU from seeded flax-default weights."""
    from ..models import HigherHRNet, init_flax_default_

    return init_flax_default_(HigherHRNet(**NET, device="cpu"), torch.Generator().manual_seed(0))


def _state(net, mesh=None):
    from ..train import TrainState, create_optimizer

    return TrainState.create(net, create_optimizer(net.parameters(), "Adam", LR), device="cpu",
                             mesh=mesh)


def _loss(metrics: dict) -> float:
    return float(metrics["loss"])


def _worker(out: str) -> None:
    """One process of the launch: the data-parallel step, then the 3-D
    mesh step; rank 0 writes the losses and the steps to ``out``."""
    import torch.distributed as dist

    from ..models.norm import convert_batch_norm
    from ..train import keypoints_train_step
    from .distributed import finalize_distributed, setup_distributed
    from .mesh import local_batch_to_global, make_mesh
    from .spatial import shard_batch_spatial
    from .tensor import make_mesh_3d, shard_state_tensor

    torch.set_num_threads(1)
    setup_distributed("cpu")
    n = dist.get_world_size()
    rank = dist.get_rank()
    batch = dryrun_batch(2 * n)
    mesh = make_mesh(n)
    state = _state(convert_batch_norm(dryrun_net(), 1, n), mesh)
    shard = {k: [t[2 * rank:2 * rank + 2] for t in v] if isinstance(v, list) else v[2 * rank:2 * rank + 2]
             for k, v in batch.items()}
    state, metrics = keypoints_train_step(state, local_batch_to_global(mesh, shard), LR)
    out_rec = {"dp": _loss(metrics), "dp_step": state.step}
    dims = mesh_dims(n)
    if dims is not None:
        mesh3 = make_mesh_3d(*dims)
        state3 = _state(shard_state_tensor(mesh3, dryrun_net()), mesh3)
        state3, metrics3 = keypoints_train_step(state3, shard_batch_spatial(mesh3, batch), LR)
        out_rec.update({"3d": _loss(metrics3), "3d_step": state3.step})
    if rank == 0:
        torch.save(out_rec, out)
    dist.barrier()
    finalize_distributed()


def dryrun_multichip(n_devices: int, timeout: float = 600.0) -> None:
    """Run the three strategies on ``n_devices`` CPU processes against one
    process (module doc); prints one "ok" line a strategy, raises on a
    miss. Every process it starts is stopped before it returns."""
    from ..train import keypoints_train_step
    from .pipeline import PipelinedModel

    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp) / "result.pt"
        procs = launch_local(n_devices, "from human_pose_tpu_torch.parallel.dryrun import _worker; "
                                        f"_worker({str(out)!r})")
        try:
            batch = dryrun_batch(2 * n_devices)
            net = dryrun_net()
            with torch.no_grad():
                ref_hms, _ = net.eval()(batch["images"])
            state, metrics = keypoints_train_step(_state(net), batch, LR)
            mono = _loss(metrics)
            logs = [p.communicate(timeout=timeout)[0] for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for rank, (p, log) in enumerate(zip(procs, logs)):
            if p.returncode:
                raise RuntimeError(f"dryrun_multichip: rank {rank} exited {p.returncode}:\n"
                                   f"{log[-4000:]}")
        rec = torch.load(out, weights_only=True)
    tol = 3e-5 * max(1.0, abs(mono))
    d_dp = abs(rec["dp"] - mono)
    if not d_dp < tol:
        raise AssertionError(f"{n_devices}-way DP loss diverged from one process: {d_dp:.2e} "
                             f"({rec['dp']:.6f} vs {mono:.6f})")
    print(f"dryrun_multichip({n_devices}): ok, mesh_devices={n_devices}, platform=cpu, "
          f"loss={rec['dp']:.4f}, step={rec['dp_step']}, max|dp-mono|={d_dp:.2e}", flush=True)
    dims = mesh_dims(n_devices)
    if dims is not None:
        d_3d = abs(rec["3d"] - mono)
        if not d_3d < tol:
            raise AssertionError(f"3-D-mesh loss diverged from one process: {d_3d:.2e} "
                                 f"({rec['3d']:.6f} vs {mono:.6f})")
        print(f"dryrun_multichip({n_devices}): ok, mesh2=(data={dims[0]}, space={dims[1]}, "
              f"model={dims[2]}), loss={rec['3d']:.4f}, step={rec['3d_step']}, "
              f"max|3d-mono|={d_3d:.2e}", flush=True)
    if n_devices >= 4:
        pipe = PipelinedModel(dryrun_net(), devices=[torch.device("cpu")] * 4)
        hms, _ = pipe(batch["images"], microbatch_size=n_devices)
        err = float((hms[1] - ref_hms[1]).abs().max())
        if not err < 1e-4:
            raise AssertionError(f"pipeline forward diverged from monolithic: {err}")
        print(f"dryrun_multichip({n_devices}): ok, pipeline segments={len(pipe.segments)} over "
              f"{len({str(d) for d in pipe.devices})} devices, max|pp-mono|={err:.2e}", flush=True)
