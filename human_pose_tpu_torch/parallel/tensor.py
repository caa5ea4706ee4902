"""Tensor (channel) parallelism and the 3-D data x space x tensor mesh
(port of human_pose_tpu/parallel/tensor.py).

In the JAX package a ``NamedSharding`` of every conv kernel's output
channels over a ``model`` axis is enough: GSPMD inserts the all-gathers
and the reductions. Here ``shard_state_tensor`` rewrites the model for the
mesh, with explicit collectives:

* every parameter leaf shards its output-channel dim over the tensor group
  when the dim divides by t, else it is replicated (``tensor_spec``, the
  JAX rule for torch layouts); a rank keeps its channel slice, so the
  optimizer built on the model afterwards holds 1/t of Adam's moments;
* an activation stays whole and equal on every rank of the tensor group. A
  sharded convolution (with the BatchNorm registered right after it, and
  the ReLU after that) is wrapped as Megatron's column-parallel layer: on
  its input, forward is the identity and backward all-reduces over the
  tensor group; on its output (after the BatchNorm), forward all-gathers
  the channels and backward keeps the rank's slice. Replicated layers then
  get equal gradients on every tensor rank, and no tensor-group reduction
  of the gradients is needed;
* every BatchNorm reduces its moments over the moment group (the ranks of
  this tensor index: the global batch's N, H and W), as
  ``SyncBatchNorm2d``; over a group of one it is ``BatchNorm2d`` itself;
* convolutions reaching past a band exchange halo rows over the space
  group (``parallel/spatial.py``).

The train steps (``train/steps.py``) average gradients and metrics over the
moment group. A sharded state saves whole (``whole_state_dicts``, used by
both checkpoint backends). ``make_mesh_3d(d, s, t)`` builds the mesh; any
axis may be 1, and a (1, 1, 1) mesh computes the plain step's numbers. At
t = 1 nothing shards and no tensor operator runs, as a model axis of 1
costs nothing in the JAX package.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from ..models.norm import BatchNorm2d, SyncBatchNorm2d
from .mesh import TENSOR_AXIS, Mesh, make_mesh_nd
from .spatial import _check_mesh, halo_rows

__all__ = ["TENSOR_AXIS", "make_mesh_3d", "shard_state_tensor", "tensor_spec", "whole_state_dicts"]

# leaf modules a mesh model may hold; anything else (a pooling, a linear
# layer) has no mesh version here and is refused
_PLAIN_LEAVES = (nn.ReLU, nn.Identity)


def make_mesh_3d(n_data: int = 1, n_space: int = 1, n_tensor: int = 1) -> Mesh | None:
    """A (data, space, model) mesh over the first ``n_data * n_space *
    n_tensor`` ranks of the default group; any axis may be 1. Raises when
    the product exceeds the world (no silent truncation); every rank of the
    default group calls it, and ranks past the product get None
    (``parallel/mesh.py::make_mesh_nd``)."""
    return make_mesh_nd((n_data, n_space, n_tensor))


def tensor_spec(module: nn.Module, leaf: str, n_tensor: int) -> int | None:
    """The dim along which the leaf ``leaf`` (a parameter or buffer name)
    of ``module`` shards over a tensor group of ``n_tensor`` ranks, or None
    (replicated): the output-channel dim, when it divides by ``n_tensor``.
    That is dim 0 of a ``Conv2d`` weight, dim 1 of a ``ConvTranspose2d``
    weight and dim 0 of a bias or a BatchNorm vector; scalars (a
    BatchNorm's ``num_batches_tracked``) replicate."""
    value = getattr(module, leaf)
    if value is None or value.ndim == 0:
        return None
    dim = 1 if isinstance(module, nn.ConvTranspose2d) and leaf == "weight" else 0
    return dim if value.shape[dim] % n_tensor == 0 else None


class _CopyToTensorGroup(torch.autograd.Function):
    """Identity forward; the backward all-reduces over the tensor group
    (each rank's gradient covers only its channel slice's share)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _GatherChannels(torch.autograd.Function):
    """All-gather of the channel slices over the tensor group; the
    backward keeps this rank's slice of the gradient."""

    @staticmethod
    def forward(ctx, y, mesh):
        parts = [torch.empty_like(y) for _ in range(mesh.n_tensor)]
        dist.all_gather(parts, y.contiguous(), group=mesh.tensor_group)
        ctx.slice = (mesh.tensor_index * y.shape[1], y.shape[1])
        return torch.cat(parts, 1)

    @staticmethod
    def backward(ctx, grad):
        return grad.narrow(1, *ctx.slice), None


def _mesh_spec(module: nn.Module, leaf: str, mesh: Mesh) -> int | None:
    """``tensor_spec`` on the mesh's tensor axis. A tensor axis of 1 (and
    a (data, space) mesh, which has none) shards nothing and so runs no
    tensor operator: (d, s, 1) is the (d, s) mesh's step."""
    return tensor_spec(module, leaf, mesh.n_tensor) if mesh.n_tensor > 1 else None


def _slice(t: torch.Tensor, dim: int | None, mesh: Mesh) -> torch.Tensor:
    if dim is None:
        return t.detach().clone()
    return t.detach().chunk(mesh.n_tensor, dim)[mesh.tensor_index].clone()


class MeshConv(nn.Module):
    """A ``Conv2d`` or ``ConvTranspose2d`` on the mesh: this rank's output
    channels when ``tensor_spec`` shards its weight (input operator before
    it, and the gather after it unless its BatchNorm gathers), and its
    band of output rows from halo rows of the neighbouring bands when its
    kernel reaches past the band. Same parameter names as the module it
    replaces."""

    def __init__(self, conv: nn.Module, mesh: Mesh, gather: bool):
        super().__init__()
        self.mesh = mesh
        self.transposed = isinstance(conv, nn.ConvTranspose2d)
        self.tensor_dims = {leaf: _mesh_spec(conv, leaf, mesh) for leaf in ("weight", "bias")}
        self.sharded = self.tensor_dims["weight"] is not None
        if self.sharded and conv.groups != 1:
            raise ValueError("a grouped convolution cannot shard its output channels")
        self.weight = nn.Parameter(_slice(conv.weight, self.tensor_dims["weight"], mesh))
        if conv.bias is None:
            self.register_parameter("bias", None)
        else:
            self.bias = nn.Parameter(_slice(conv.bias, self.tensor_dims["bias"], mesh))
        self.gather = self.sharded and gather
        self.stride, self.padding, self.dilation, self.groups = (
            conv.stride, conv.padding, conv.dilation, conv.groups)
        self.output_padding = conv.output_padding if self.transposed else None
        k, st, p = conv.kernel_size[0], conv.stride[0], conv.padding[0]
        if conv.dilation[0] != 1 or (self.transposed and conv.output_padding[0]):
            raise ValueError("no mesh version of a dilated convolution or an output padding")
        if self.transposed:  # input rows of output band [st*r0, st*(r0+L))
            self.halo = ((k - 1 - p) // st, (p - 1 + st) // st)
        else:  # above: a whole stride phase; below: what the last output reaches
            self.halo = (-(-p // st) * st, max(0, k - p - st))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mesh = self.mesh
        if self.sharded:
            x = _CopyToTensorGroup.apply(x, mesh.tensor_group)
        rows, st = x.shape[2], self.stride[0]
        if mesh.n_space > 1 and not self.transposed and rows % st:
            raise ValueError(f"a band of {rows} rows does not split by the stride {st}")
        x, a, b = halo_rows(x, *self.halo, mesh)
        if self.transposed:
            y = F.conv_transpose2d(x, self.weight, self.bias, self.stride, self.padding,
                                   self.output_padding, self.groups, self.dilation)
            start, count = st * a, st * rows
        else:
            y = F.conv2d(x, self.weight, self.bias, self.stride, self.padding, self.dilation,
                         self.groups)
            start, count = a // st, rows // st
        if a or b:
            if y.shape[2] < start + count:
                raise ValueError(f"the convolution's padding leaves {y.shape[2]} rows, "
                                 f"{start + count} needed")
            y = y.narrow(2, start, count)
        return _GatherChannels.apply(y, mesh) if self.gather else y


class MeshBatchNorm2d(SyncBatchNorm2d):
    """A BatchNorm on the mesh: moments over the moment group (the plain
    ``BatchNorm2d`` over a group of one), this rank's channel slice when
    ``tensor_spec`` shards it, then the gather of the channels. Same
    parameter and buffer names as the module it replaces."""

    def __init__(self, bn: BatchNorm2d, mesh: Mesh):
        dims = {leaf: _mesh_spec(bn, leaf, mesh)
                for leaf in ("weight", "bias", "running_mean", "running_var")}
        sharded = dims["weight"] is not None
        super().__init__(bn.num_features // mesh.n_tensor if sharded else bn.num_features,
                         eps=bn.eps, momentum=bn.momentum, group=mesh.group, device=bn.weight.device,
                         dtype=bn.weight.dtype)
        self.tensor_dims, self.sharded, self.mesh = dims, sharded, mesh
        with torch.no_grad():
            for leaf, dim in self.tensor_dims.items():
                getattr(self, leaf).copy_(_slice(getattr(bn, leaf), dim, mesh))
            self.num_batches_tracked.copy_(bn.num_batches_tracked)
        self.train(bn.training)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        sync = self.training and self.mesh.world_size > 1
        y = SyncBatchNorm2d.forward(self, x) if sync else BatchNorm2d.forward(self, x)
        return _GatherChannels.apply(y, self.mesh) if self.sharded else y


def shard_state_tensor(mesh: Mesh, model: nn.Module) -> nn.Module:
    """Put ``model`` (a HigherHRNet, or any net of convolutions, flax-style
    ``BatchNorm2d``, ReLU and nearest upsampling, on ``mesh.device``) on
    the mesh in place (see the module doc): every ``Conv2d`` and
    ``ConvTranspose2d`` becomes a ``MeshConv``, every BatchNorm a
    ``MeshBatchNorm2d``, each holding this rank's slice. A BatchNorm shards
    exactly when the convolution registered right before it does (the
    port's conv + BN pairs). Build the optimizer on the model afterwards.
    Returns ``model``."""
    _check_mesh(mesh)
    for name, m in model.named_modules():
        if next(m.children(), None) is not None or isinstance(
                m, (nn.Conv2d, nn.ConvTranspose2d, *_PLAIN_LEAVES)) or type(m) is BatchNorm2d:
            continue
        if isinstance(m, nn.Upsample) and m.mode == "nearest":
            continue
        raise ValueError(f"{name} ({type(m).__name__}) has no mesh version")
    for parent in list(model.modules()):
        children = list(parent.named_children())
        new = {}
        for i, (name, child) in enumerate(children):
            if isinstance(child, (nn.Conv2d, nn.ConvTranspose2d)):
                follower = children[i + 1][1] if i + 1 < len(children) else None
                paired = (type(follower) is BatchNorm2d
                          and follower.num_features == child.out_channels)
                new[name] = MeshConv(child, mesh, gather=not paired)
            elif type(child) is BatchNorm2d:
                new[name] = MeshBatchNorm2d(child, mesh)
                before = new.get(children[i - 1][0]) if i else None
                conv_sharded = isinstance(before, MeshConv) and before.sharded and not before.gather
                if new[name].sharded != conv_sharded:
                    raise ValueError(f"BatchNorm {name} shards as {new[name].sharded}, the "
                                     "convolution before it as the opposite")
        for name, module in new.items():
            setattr(parent, name, module)
    return model


def _tensor_dims(model: nn.Module) -> dict:
    """{state-dict key: sharded dim} of a model on a mesh."""
    return {f"{prefix}.{leaf}" if prefix else leaf: dim
            for prefix, m in model.named_modules() if isinstance(m, (MeshConv, MeshBatchNorm2d))
            for leaf, dim in m.tensor_dims.items() if dim is not None and getattr(m, leaf) is not None}


def _whole(t: torch.Tensor, dim: int, mesh: Mesh) -> torch.Tensor:
    parts = [torch.empty_like(t) for _ in range(mesh.n_tensor)]
    dist.all_gather(parts, t.detach().contiguous(), group=mesh.tensor_group)
    return torch.cat(parts, dim)


def whole_state_dicts(state) -> tuple[dict, dict]:
    """The model's and the optimizer's state dicts of a ``TrainState``,
    every tensor-sharded leaf (and its optimizer moments) gathered whole
    over the tensor group: what a one-process state of the same model
    holds. Every rank of the mesh calls it when the tensor axis is > 1;
    otherwise it returns the live state dicts."""
    model_sd, optim_sd = state.model.state_dict(), state.optimizer.state_dict()
    mesh = state.mesh
    if mesh is None or mesh.n_tensor == 1:
        return model_sd, optim_sd
    dims = _tensor_dims(state.model)
    model_sd = {k: _whole(v, dims[k], mesh) if k in dims else v for k, v in model_sd.items()}
    names = {id(p): n for n, p in state.model.named_parameters()}
    params = [p for group in state.optimizer.param_groups for p in group["params"]]
    whole_opt = {}
    for pid, entries in optim_sd["state"].items():
        p = params[pid]
        dim = dims.get(names[id(p)])
        whole_opt[pid] = {key: _whole(v, dim, mesh)
                          if dim is not None and torch.is_tensor(v) and v.shape == p.shape else v
                          for key, v in entries.items()}
    return model_sd, {**optim_sd, "state": whole_opt}
