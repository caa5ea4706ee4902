"""Worker processes of tests/test_torch_port_model_parallel.py (torch and the
port only, no tests here): one gloo launch of ``WORLD`` processes runs one
keypoints step of the shallow C=8 HigherHRNet at 64x64 on every mesh of
``MESHES`` in float32 (the metrics) and in float64 (the gradients), an eval
forward on the (2, 2, 2) mesh, and both checkpoint backends on a
tensor-sharded state; the test process compares the results with one
process and with the JAX package.

Launched with torchrun's variables (``RANK``, ``WORLD_SIZE``,
``MASTER_ADDR``, ``MASTER_PORT``)::

    python -c "from tests.test_torch_port_model_parallel_worker import worker; worker('out')"
"""

from __future__ import annotations

from pathlib import Path

import torch
import torch.distributed as dist

from human_pose_tpu_torch.models import HigherHRNet, init_flax_default_
from human_pose_tpu_torch.models.norm import BatchNorm2d
from human_pose_tpu_torch.parallel import (
    finalize_distributed, gather_rows, make_mesh_3d, setup_distributed, shard_batch_spatial,
    shard_state_tensor,
)
from human_pose_tpu_torch.parallel.dryrun import LR, NET, dryrun_batch
from human_pose_tpu_torch.parallel.tensor import _tensor_dims, _whole
from human_pose_tpu_torch.train import TrainState, create_optimizer, keypoints_train_step
from human_pose_tpu_torch.train import checkpoint, checkpoint_orbax

WORLD = 8
MESHES = ((1, 1, 2), (1, 2, 1), (4, 1, 2), (2, 2, 2))
CKPT_MESH = (4, 1, 2)
FORWARD_MESH = (2, 2, 2)
SEED = 0


@torch.no_grad()
def make_net(device: str = "cpu") -> HigherHRNet:
    """The shallow net from seeded weights: flax's default convs, then
    seeded non-trivial BatchNorm scales, biases and running statistics and
    conv biases, so a misplaced channel slice shows."""
    net = HigherHRNet(**NET, device=device)
    gen = torch.Generator().manual_seed(SEED)
    init_flax_default_(net, gen)
    for m in net.modules():
        if isinstance(m, BatchNorm2d):
            m.weight.copy_(1 + 0.2 * torch.randn(m.weight.shape, generator=gen))
            m.bias.copy_(0.1 * torch.randn(m.bias.shape, generator=gen))
            m.running_mean.copy_(0.1 * torch.randn(m.running_mean.shape, generator=gen))
            m.running_var.copy_(1 + 0.5 * torch.rand(m.running_var.shape, generator=gen))
        elif isinstance(m, torch.nn.Conv2d) and m.bias is not None:
            m.bias.copy_(0.1 * torch.randn(m.bias.shape, generator=gen))
    return net


def as_dtype(batch: dict, dtype: torch.dtype) -> dict:
    """The batch with its floating tensors in ``dtype``."""
    def cast(x):
        if isinstance(x, list):
            return [cast(v) for v in x]
        return x.to(dtype) if x.is_floating_point() else x
    return {k: cast(v) for k, v in batch.items()}


def moments(state: TrainState) -> dict:
    """{parameter name: Adam's moments of it}, looked up by the parameter
    itself (not through the optimizer's numbering)."""
    return {n: {k: v.clone() for k, v in state.optimizer.state[p].items() if k != "step"}
            for n, p in state.model.named_parameters()}


def step_result(state: TrainState, metrics: dict, grads: dict) -> dict:
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "grads": {k: g.clone() for k, g in grads.items()},
            "state": {k: v.clone() for k, v in state.model.state_dict().items()},
            "moments": moments(state)}


def plain_step(dtype: torch.dtype = torch.float32) -> dict:
    """One process, no mesh: the step every mesh is held to, with the net
    and the batch in ``dtype``."""
    net = make_net().to(dtype)
    state = TrainState.create(net, create_optimizer(net.parameters(), "Adam", LR), device="cpu")
    state, metrics = keypoints_train_step(state, as_dtype(dryrun_batch(WORLD), dtype), LR)
    return step_result(state, metrics, {n: p.grad for n, p in net.named_parameters()})


def _mesh_state(mesh, dtype: torch.dtype = torch.float32) -> TrainState:
    net = shard_state_tensor(mesh, make_net().to(dtype))
    return TrainState.create(net, create_optimizer(net.parameters(), "Adam", LR), device="cpu",
                             mesh=mesh)


def _whole_grads(mesh, model) -> dict:
    dims = _tensor_dims(model) if mesh.n_tensor > 1 else {}
    return {n: _whole(p.grad, dims[n], mesh) if n in dims else p.grad
            for n, p in model.named_parameters()}


def _opt_numel(optimizer) -> int:
    return sum(v.numel() for entries in optimizer.state_dict()["state"].values()
               for v in entries.values() if torch.is_tensor(v) and v.ndim)


def worker(out: str) -> None:
    torch.set_num_threads(1)
    out = Path(out)
    setup_distributed("cpu")
    rank = dist.get_rank()
    batch = dryrun_batch(WORLD)
    results = {}
    for dims in MESHES:
        mesh = make_mesh_3d(*dims)
        if mesh is None:  # outside this mesh: only its groups were built
            continue
        state = _mesh_state(mesh)
        rec = {"coords": mesh.coords, "shape": mesh.shape}
        if dims == CKPT_MESH:  # the freshly sharded state, before any step
            checkpoint.save_checkpoint(out / "fresh.pt", state, epoch=0)
            checkpoint_orbax.save_checkpoint(out / "fresh_dir", state, epoch=0)
        if dims == FORWARD_MESH:
            state.model.eval()
            with torch.no_grad():
                hms, tags = state.model(shard_batch_spatial(mesh, batch)["images"])
                rec["forward"] = [gather_rows(t, mesh) for t in (*hms, tags)]
        state, metrics = keypoints_train_step(state, shard_batch_spatial(mesh, batch), LR)
        rec.update(step_result(state, metrics, {}))
        rec["opt_numel"] = _opt_numel(state.optimizer)
        # the gradients in float64: in float32 a ReLU input within rounding
        # of 0 may flip between summation orders (tests/test_torch_port_model_parallel.py)
        state64 = _mesh_state(mesh, torch.float64)
        keypoints_train_step(state64, shard_batch_spatial(mesh, as_dtype(batch, torch.float64)), LR)
        rec["grads"] = _whole_grads(mesh, state64.model)
        if dims == CKPT_MESH:  # the stepped float64 state, and each rank's own slices of it
            checkpoint.save_checkpoint(out / "step64.pt", state64, epoch=3)
            checkpoint_orbax.save_checkpoint(out / "step64_dir", state64, epoch=3)
            rec["slices64"] = {"params": {n: p.detach().clone() for n, p in state64.model.named_parameters()},
                               "moments": moments(state64), "dims": _tensor_dims(state64.model)}
        if rank:  # every rank's metrics and slices; rank 0 keeps the rest
            rec = {k: v for k, v in rec.items() if k in ("coords", "metrics", "opt_numel", "slices64")}
        results[dims] = rec
    torch.save(results, out / f"rank{rank}.pt")
    dist.barrier()
    finalize_distributed()
