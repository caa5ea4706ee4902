"""Spatial partitioning: image rows over a ``space`` mesh axis (port of
human_pose_tpu/parallel/spatial.py).

In the JAX package GSPMD shards the H dim of the activations and inserts
the halo exchanges and the BatchNorm reductions itself. Here each rank of a
space group holds one band of rows of every activation (``[N, C, h, W]``,
band s of n_space, equal bands) and the collectives are explicit:

* a convolution whose kernel reaches past its band (``halo_rows``)
  receives the rows it needs from its neighbours and sends them the rows
  they need; its backward sends the halo's gradient back, where it is added
  into the edge rows. A stride-2 3x3 convolution takes two rows from above
  so that the band keeps the global stride phase, and the deconv head's
  ``ConvTranspose2d(4, 2, 1)`` one row each side; both crop their output
  to the band. 1x1 convolutions and HRNet's nearest upsample need nothing.
  At the global edges there is no neighbour and the convolution's own zero
  padding is the unsharded one's;
* BatchNorm moments reduce over the moment group (data and space), so
  they are the global batch's over N, H and W, as in JAX;
* the AE tag loss reads tags at joints that may lie in any band, so the
  train step gathers the tag maps over the space group first
  (``gather_rows``). Each band's heatmap loss is its band's mean, n_space
  times its share of the global mean; the train step averages gradients
  and metrics over the moment group (``parallel/mesh.py``), so the gather's
  backward hands each band its gradient times n_space.

Bands must divide the rows of every stride: images of H rows split into
bands of a multiple of 32 rows (the backbone's deepest stride), else
``ValueError``; nothing is padded. ``parallel/tensor.py::shard_state_tensor``
puts a model on the mesh; ``shard_batch_spatial`` places a batch.
"""

from __future__ import annotations

from typing import Any

import torch
import torch.distributed as dist

from .mesh import SPACE_AXIS, Mesh, make_mesh_nd

__all__ = ["SPACE_AXIS", "gather_rows", "halo_rows", "make_mesh_2d", "shard_batch_spatial"]

# batch leaves that have no rows: joints are [N, persons, K, 3] and labels
# [N]; everything else in the training batches is [N, C, H, W] or [N, H, W]
_NO_SPACE_LEAVES = ("joints", "labels", "image_ids")

# the rows of a band of images are a multiple of this: HigherHRNet's
# deepest branch is at 1/32 and its stride-2 convolutions need even bands
IMAGE_ROW_ALIGN = 32


def make_mesh_2d(n_data: int, n_space: int) -> Mesh | None:
    """A (data, space) mesh over the first ``n_data * n_space`` ranks of
    the default group (``parallel/mesh.py::make_mesh_nd``); raises when the
    product exceeds the world (no silent truncation)."""
    return make_mesh_nd((n_data, n_space))


def _check_mesh(mesh: Mesh) -> None:
    if not mesh.dims:
        raise ValueError("a (data, space[, model]) mesh of make_mesh_2d or make_mesh_3d is "
                         "needed; the 1-D data mesh has no space axis")


def shard_batch_spatial(mesh: Mesh, tree: Any) -> Any:
    """This rank's part of a global batch on ``mesh.device``: dim 0 split
    over the data axis, and the rows (dim 2 of ``[N, C, H, W]``, dim 1 of
    ``[N, H, W]``) over the space axis, except the leaves whose dim 1 is not
    rows (``_NO_SPACE_LEAVES``, matched by key name, and leaves of fewer
    than 3 dims), which split over data only. Raises when a split is not
    even or the images' bands are not multiples of 32 rows."""
    _check_mesh(mesh)
    n_data, n_space = mesh.dims[0], mesh.n_space
    d, s = mesh.coords[0], mesh.space_index

    def place(key: str, x):
        x = torch.as_tensor(x)
        n = x.shape[0]
        if n % n_data:
            raise ValueError(f"{key}: batch {n} does not split over {n_data} data shards")
        x = x.narrow(0, d * (n // n_data), n // n_data)
        if x.ndim >= 3 and not any(name in key for name in _NO_SPACE_LEAVES):
            dim = x.ndim - 2
            rows = x.shape[dim]
            align = IMAGE_ROW_ALIGN * n_space if key.startswith("images") else n_space
            if rows % align:
                raise ValueError(f"{key}: {rows} rows do not split into {n_space} bands"
                                 + (f" of a multiple of {IMAGE_ROW_ALIGN} rows"
                                    if key.startswith("images") else ""))
            x = x.narrow(dim, s * (rows // n_space), rows // n_space)
        return x.to(mesh.device, non_blocking=True)

    def walk(key: str, x):
        if isinstance(x, dict):
            return type(x)({k: walk(f"{key}/{k}" if key else str(k), v) for k, v in x.items()})
        if isinstance(x, (list, tuple)):
            return type(x)(walk(f"{key}/{i}", v) for i, v in enumerate(x))
        return place(key, x)

    return walk("", tree)


def _neighbours(mesh: Mesh) -> tuple:
    """The global ranks of the bands above and below this one (None at the
    image's edges)."""
    s, ranks = mesh.space_index, mesh.space_ranks
    up = ranks[s - 1] if s > 0 else None
    down = ranks[s + 1] if s + 1 < len(ranks) else None
    return up, down


def _exchange(sends: list, recvs: list, group) -> None:
    ops = ([dist.P2POp(dist.isend, t, peer, group) for t, peer in sends]
           + [dist.P2POp(dist.irecv, t, peer, group) for t, peer in recvs])
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()


class _HaloRows(torch.autograd.Function):
    """``x`` with ``above`` rows of the band above and ``below`` rows of
    the band below around it (none at an image edge); the backward adds the
    gradient of the rows sent to the neighbours into their edge rows."""

    @staticmethod
    def forward(ctx, x, above, below, mesh):
        up, down = _neighbours(mesh)
        a, b = (above if up is not None else 0), (below if down is not None else 0)
        x = x.contiguous()
        shape = list(x.shape)
        top = x.new_empty(shape[:2] + [a] + shape[3:])
        bottom = x.new_empty(shape[:2] + [b] + shape[3:])
        sends, recvs = [], []
        if up is not None:
            recvs += [(top, up)] if a else []
            sends += [(x[:, :, :below].contiguous(), up)] if below else []
        if down is not None:
            recvs += [(bottom, down)] if b else []
            sends += [(x[:, :, x.shape[2] - above:].contiguous(), down)] if above else []
        _exchange(sends, recvs, mesh.space_group)
        ctx.rows = (a, b, above, below, x.shape[2])
        ctx.mesh = mesh
        return torch.cat([top, x, bottom], 2)

    @staticmethod
    def backward(ctx, grad):
        a, b, above, below, rows = ctx.rows
        up, down = _neighbours(ctx.mesh)
        grad = grad.contiguous()
        gx = grad[:, :, a:a + rows].clone()
        shape = list(gx.shape)
        from_up = gx.new_empty(shape[:2] + [below] + shape[3:])
        from_down = gx.new_empty(shape[:2] + [above] + shape[3:])
        sends, recvs = [], []
        if up is not None:
            sends += [(grad[:, :, :a].contiguous(), up)] if a else []
            recvs += [(from_up, up)] if below else []
        if down is not None:
            sends += [(grad[:, :, a + rows:].contiguous(), down)] if b else []
            recvs += [(from_down, down)] if above else []
        _exchange(sends, recvs, ctx.mesh.space_group)
        if up is not None and below:
            gx[:, :, :below] += from_up
        if down is not None and above:
            gx[:, :, rows - above:] += from_down
        return gx, None, None, None


def halo_rows(x: torch.Tensor, above: int, below: int, mesh: Mesh) -> tuple:
    """``(x_with_halo, a, b)``: ``x`` (``[N, C, rows, W]``, this rank's
    band) with the ``a`` rows above it and the ``b`` rows below it that
    its neighbours hold (``above``/``below``, or 0 at an image edge).
    Raises when a band is shorter than the rows asked of it."""
    if mesh.n_space == 1 or not (above or below):
        return x, 0, 0
    if x.shape[2] < max(above, below):
        raise ValueError(f"a band of {x.shape[2]} rows cannot lend {max(above, below)} halo "
                         "rows; use fewer space shards or larger images")
    up, down = _neighbours(mesh)
    a, b = (above if up is not None else 0), (below if down is not None else 0)
    return _HaloRows.apply(x, above, below, mesh), a, b


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        parts = [torch.empty_like(x) for _ in range(mesh.n_space)]
        dist.all_gather(parts, x.contiguous(), group=mesh.space_group)
        ctx.mesh, ctx.rows = mesh, x.shape[2]
        return torch.cat(parts, 2)

    @staticmethod
    def backward(ctx, grad):
        mesh = ctx.mesh
        band = grad.narrow(2, mesh.space_index * ctx.rows, ctx.rows)
        return (band * mesh.n_space if mesh.n_space > 1 else band), None


def gather_rows(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The whole ``[N, C, H, W]`` map from every band of the space group;
    the backward keeps this rank's band of the gradient, times n_space
    (see the module doc)."""
    _check_mesh(mesh)
    return _GatherRows.apply(x, mesh)
