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
(``gather_to_main``).

The same ``Mesh`` describes the (data, space) and (data, space, model)
meshes of ``parallel/spatial.py`` and ``parallel/tensor.py``
(``make_mesh_nd``): the ranks of the default group laid out row-major over
the axes, with a process group for each line of ranks along an axis and
the "moment" group of the ranks that share a tensor index, over which
BatchNorm moments, gradients and metrics reduce. There ``group`` is the
moment group and ``world_size`` its size.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any

import torch
import torch.distributed as dist

from ..models.norm import BatchNorm2d, SyncBatchNorm2d

DATA_AXIS = "data"
SPACE_AXIS = "space"
TENSOR_AXIS = "model"


@dataclass(frozen=True)
class Mesh:
    """This process's place in the data-parallel group: its rank, the
    world size, its device and the process group (None: the default).

    A mesh of ``make_mesh_nd`` also has ``dims`` (the size of each axis,
    (data, space) or (data, space, model)), this rank's index on each
    (``coords``), the groups along the space and the tensor axes and the
    global ranks of the space group in axis order; ``group`` is then the
    moment group
    (the data and space axes at this rank's tensor index) and
    ``world_size`` its size: the processes over which gradients, metrics
    and BatchNorm moments reduce."""

    rank: int
    world_size: int
    device: torch.device
    group: Any = None
    dims: tuple = ()
    coords: tuple = ()
    space_group: Any = None
    tensor_group: Any = None
    space_ranks: tuple = ()

    @property
    def shape(self) -> dict:
        if not self.dims:
            return {DATA_AXIS: self.world_size}
        return dict(zip((DATA_AXIS, SPACE_AXIS, TENSOR_AXIS), self.dims))

    @property
    def n_space(self) -> int:
        return self.dims[1] if self.dims else 1

    @property
    def n_tensor(self) -> int:
        return self.dims[2] if len(self.dims) > 2 else 1

    @property
    def space_index(self) -> int:
        return self.coords[1] if self.dims else 0

    @property
    def tensor_index(self) -> int:
        return self.coords[2] if len(self.dims) > 2 else 0


def _mesh_device() -> torch.device:
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


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
    return Mesh(rank=dist.get_rank(), world_size=world, device=_mesh_device())


def make_mesh_nd(dims: tuple) -> Mesh | None:
    """The (data, space) or (data, space, model) mesh of ``dims`` over the
    first ``prod(dims)`` ranks of the default group, laid out row-major
    (rank = ((d * n_space) + s) * n_tensor + t, as the JAX package reshapes
    its devices). Every rank of the default group must call it, in the same
    order as its other calls: each builds every subgroup (``new_group`` is
    collective). Ranks past the product get None. Raises without a process
    group and when the product exceeds the world (no silent truncation)."""
    if not dist.is_initialized():
        raise RuntimeError("a mesh needs a torch.distributed process group "
                           "(parallel.setup_distributed under torchrun)")
    world, need = dist.get_world_size(), math.prod(dims)
    if any(d < 1 for d in dims) or need > world:
        raise ValueError(f"requested a {'x'.join(map(str, dims))} mesh but only {world} "
                         "devices are available")
    full = (*dims, 1, 1)[:3]
    grid = torch.arange(need).reshape(full)

    def lines(g):  # the ranks of each group, every group in a fixed order
        return [tuple(int(r) for r in row) for row in g.reshape(-1, g.shape[-1])]

    groups = {}
    # the data axis needs no group of its own: every reduction over it also
    # runs over the space axis, in the moment group
    for name, g in (("space", grid.permute(0, 2, 1)), ("tensor", grid),
                    ("moment", grid.permute(2, 0, 1).reshape(full[2], -1))):
        for ranks in lines(g):
            handle = dist.new_group(list(ranks))
            for r in ranks:
                groups.setdefault((name, r), (handle, ranks))
    rank = dist.get_rank()
    if rank >= need:
        return None
    coords = tuple(int(i) for i in (grid == rank).nonzero()[0])
    moment, moment_ranks = groups[("moment", rank)]
    return Mesh(rank=rank, world_size=len(moment_ranks), device=_mesh_device(), group=moment,
                dims=tuple(dims), coords=coords[:len(dims)],
                space_group=groups[("space", rank)][0], tensor_group=groups[("tensor", rank)][0],
                space_ranks=groups[("space", rank)][1])


def require_data_mesh(mesh: Mesh, what: str) -> None:
    """Refuse a (data, space[, model]) mesh where only the 1-D data mesh
    of ``make_mesh`` is meant: there ``group`` is the moment group, which
    need not hold rank 0 nor every data shard."""
    if mesh.dims:
        raise ValueError(f"{what} takes the data-parallel mesh of make_mesh, not the "
                         f"{'x'.join(map(str, mesh.dims))} mesh of make_mesh_2d/make_mesh_3d")


def barrier(name: str = "barrier") -> None:
    """Every process waits here until all have reached it
    (``dist.barrier``); nothing in one process. ``name`` is the JAX
    package's label and only names the point."""
    if dist.is_initialized():
        dist.barrier()


def gather_to_main(mesh: Mesh, obj: Any) -> list | None:
    """Every process's picklable ``obj`` on rank 0, in rank order
    (``dist.gather_object``: under NCCL through the current card); None on
    the other ranks. A 1-D data mesh only (``require_data_mesh``)."""
    require_data_mesh(mesh, "gather_to_main")
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
    (src/base/model.py:45-48). A 1-D data mesh only
    (``require_data_mesh``). Returns ``model``."""
    require_data_mesh(mesh, "replicate_global")
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
