"""Data-parallel training over the processes of a ``torch.distributed``
group (port of the data-parallel part of human_pose_tpu/parallel/mesh.py;
counterpart of the reference's DDP machinery, SURVEY.md §2.8).

The JAX package runs one program over a 1-D ``data`` mesh: the batch is
sharded, the parameters replicated, and XLA turns the gradients and the
metrics into global reductions. Here each process owns one device and its
shard of every global batch (``data/loader.py``'s block-per-batch shards),
and the train steps make the same reductions explicitly when the state
holds a ``Mesh`` (``train/steps.py``):

* the parameter gradients are all-reduced and divided by the world size
  after the (accumulated) backward: with equal shards, the gradient of the
  global batch's mean loss, as JAX's;
* the BatchNorm running statistics of per-process scopes are averaged the
  same way (``average_running_stats_``; JAX's ``LocalBatchNorm`` moves them
  towards the mean over groups);
* the step's metrics are averaged before the host reads them.

``DistributedDataParallel`` is not used: its ``broadcast_buffers`` copies
rank 0's running statistics over the others'. The sharded COCO evaluation
(``inference/batched_eval.py``) gathers its per-image records to rank 0
(``gather_to_main``). Spatial, tensor and pipeline parallelism are not
ported (ROADMAP 14c).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch
import torch.distributed as dist

from ..models.norm import BatchNorm2d, SyncBatchNorm2d

DATA_AXIS = "data"


@dataclass(frozen=True)
class Mesh:
    """This process's place in the data-parallel group: its rank, the
    world size, its device and the process group (None: the default)."""

    rank: int
    world_size: int
    device: torch.device
    group: Any = None

    @property
    def shape(self) -> dict:
        return {DATA_AXIS: self.world_size}


def make_mesh(num_devices: int | None = None) -> Mesh:
    """The mesh of the default process group, one device a process: the
    current card under NCCL, the CPU under gloo. Raises without a process
    group, and when ``num_devices`` asks for more devices than the group
    has (a smaller mesh would need a group of its own: also refused)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a torch.distributed process group "
                           "(parallel.setup_distributed under torchrun)")
    world = dist.get_world_size()
    if num_devices is not None and num_devices != world:
        raise ValueError(f"requested a {num_devices}-device mesh but the process group has "
                         f"{world} processes, one device each; a truncated mesh would not "
                         "exercise the requested sharding")
    if dist.get_backend() == "nccl":
        device = torch.device("cuda", torch.cuda.current_device())
    else:
        device = torch.device("cpu")
    return Mesh(rank=dist.get_rank(), world_size=world, device=device)


def barrier(name: str = "barrier") -> None:
    """Every process waits here until all have reached it
    (``dist.barrier``); nothing in one process. ``name`` is the JAX
    package's label and only names the point."""
    if dist.is_initialized():
        dist.barrier()


def gather_to_main(mesh: Mesh, obj: Any) -> list | None:
    """Every process's picklable ``obj`` on rank 0, in rank order
    (``dist.gather_object``: under NCCL through the current card); None on
    the other ranks."""
    out = [None] * mesh.world_size if mesh.rank == 0 else None
    dist.gather_object(obj, out, dst=0, group=mesh.group)
    return out


def all_reduce_mean_(mesh: Mesh, tensors: list) -> None:
    """Replace each tensor of ``tensors`` (on ``mesh.device``) by its mean
    over the processes: one SUM all-reduce of a flat buffer a dtype, then a
    division by the world size (exact at world size 1)."""
    by_dtype: dict = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for group in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in group])
        dist.all_reduce(flat, group=mesh.group)
        flat.div_(mesh.world_size)
        for t, part in zip(group, flat.split([t.numel() for t in group])):
            t.copy_(part.view_as(t))


def average_gradients_(mesh: Mesh, model: torch.nn.Module) -> None:
    """Average every parameter gradient of ``model`` over the processes."""
    all_reduce_mean_(mesh, [p.grad for p in model.parameters() if p.grad is not None])


def average_running_stats_(mesh: Mesh, model: torch.nn.Module) -> None:
    """Average the running statistics of ``model``'s per-process BatchNorms
    over the processes (a ``SyncBatchNorm2d``'s are equal already)."""
    buffers = [b for m in model.modules()
               if isinstance(m, BatchNorm2d) and not isinstance(m, SyncBatchNorm2d)
               for b in (m.running_mean, m.running_var)]
    if buffers:
        all_reduce_mean_(mesh, buffers)


def replicate_global(mesh: Mesh, model: torch.nn.Module) -> torch.nn.Module:
    """Make every process hold rank 0's parameters and buffers (a broadcast
    of one flat buffer a dtype, in place), as the reference's DDP does at
    wrap time; every process initializes from the same seed anyway
    (src/base/model.py:45-48). Returns ``model``."""
    tensors = [t.data for t in (*model.parameters(), *model.buffers())]
    by_dtype: dict = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    with torch.no_grad():
        for group in by_dtype.values():
            flat = torch.cat([t.reshape(-1) for t in group])
            dist.broadcast(flat, src=0, group=mesh.group)
            for t, part in zip(group, flat.split([t.numel() for t in group])):
                t.copy_(part.view_as(t))
    return model


def local_batch_to_global(mesh: Mesh, tree: Any) -> Any:
    """Each process's batch is its shard of the global batch
    (``data/loader.py``): it stays this process's, on ``mesh.device``.
    Tensors of nested dicts, lists and tuples are moved there; the rest is
    returned as it is."""
    if torch.is_tensor(tree):
        return tree.to(mesh.device, non_blocking=True)
    if isinstance(tree, dict):
        return type(tree)({k: local_batch_to_global(mesh, v) for k, v in tree.items()})
    if isinstance(tree, (list, tuple)):
        return type(tree)(local_batch_to_global(mesh, v) for v in tree)
    return tree
