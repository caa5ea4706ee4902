"""BatchNorm for the port's models (port of human_pose_tpu/models/norm.py).

The JAX package's ``batch_norm`` is flax's ``nn.BatchNorm`` at momentum 0.9,
eps 1e-5. In eval mode it normalizes with the running statistics, as
``nn.BatchNorm2d`` does. In train mode the two differ:

* flax takes the batch variance as E[x^2] - E[x]^2, clipped at 0, both
  moments in float32 (``use_fast_variance``, ``force_float32_reductions``);
* flax moves ``running_var`` towards that biased variance; ``nn.BatchNorm2d``
  moves it towards the unbiased one, n / (n - 1) times larger.

``BatchNorm2d`` below keeps ``nn.BatchNorm2d``'s eval path and its
state-dict keys and does flax's train step.

The JAX package's ``bn_groups`` picks the statistics scope over the GLOBAL
batch (one process, or a batch sharded over a device mesh): 1 is flax's
``nn.BatchNorm`` over all of it, g > 1 is ``LocalBatchNorm(num_groups=g)``
(the reference's per-device statistics, ``parallel/sync_bn.py``). Here a
process holds only its own shard, so ``convert_batch_norm`` maps that
choice onto each process of a data-parallel mesh of ``world_size``
processes (the config passes the mesh's; 1 without a mesh):

* one process: ``BatchNorm2d`` for 1 group, ``LocalBatchNorm(g)`` for g;
* W processes, 1 group: ``SyncBatchNorm2d``, moments over the group
  (flax's ``nn.BatchNorm`` over the sharded batch; the reference's
  ``sync_batchnorm: true``);
* W processes, g = W * l groups: ``LocalBatchNorm(l)`` over each shard
  (JAX's two-pass moments, normalized by ``BatchNorm2d``'s kernels); the
  train steps average the running statistics over the processes after
  each update (``parallel/mesh.py::average_running_stats_``), so every
  process holds JAX's mean over groups.

Every variant keeps ``BatchNorm2d``'s parameters, buffers and eval path.

Under rematerialization (``remat``, ``torch.utils.checkpoint``) a train
forward runs twice, the second time in the backward; flax's remat is
functional and moves the running statistics once. ``frozen_running_stats()``
is the context the recompute runs in: the batch statistics are the same,
the running ones stay where the first forward left them.
"""

from __future__ import annotations

import contextlib
import threading

import torch
import torch.distributed as dist
from torch import nn

_recompute = threading.local()


@contextlib.contextmanager
def frozen_running_stats():
    """Train-mode ``BatchNorm2d`` forwards in this block (this thread) use
    the batch statistics but leave ``running_mean``, ``running_var`` and
    ``num_batches_tracked`` as they are."""
    before = getattr(_recompute, "active", False)
    _recompute.active = True
    try:
        yield
    finally:
        _recompute.active = before

BN_MOMENTUM = 0.1  # torch convention (flax 0.9)
BN_EPS = 1e-5


class _NormalizeWithStats(torch.autograd.Function):
    """``(x - mean) * rsqrt(var + eps) * weight + bias`` with ``mean`` and
    ``var`` the batch moments of ``x``: the backward is the batch-statistics
    BatchNorm gradient, which counts the moments' dependence on ``x``."""

    @staticmethod
    def forward(ctx, x, weight, bias, mean, var, eps):
        y = torch.ops.aten.native_batch_norm(x, weight, bias, mean, var, False, 0.0, eps)[0]
        ctx.save_for_backward(x, weight, mean, torch.rsqrt(var + eps))
        ctx.eps = eps
        return y

    @staticmethod
    def backward(ctx, grad_y):
        x, weight, mean, invstd = ctx.saved_tensors
        grad_y = grad_y.contiguous()
        need_x, need_w, need_b = ctx.needs_input_grad[:3]
        if x.dtype not in (torch.bfloat16, torch.float16):
            grad_x, grad_w, grad_b = torch.ops.aten.native_batch_norm_backward(
                grad_y, x, weight, None, None, mean, invstd, True, ctx.eps, [need_x, need_w, need_b])
            return grad_x, grad_w, grad_b, None, None, None
        # A bf16 or fp16 x takes the port's kernel pair (its plain version on
        # the CPU): grad_x in x's dtype, the weight's and the bias's
        # gradients float32 sums, as JAX's bf16 step keeps them (CUDA's
        # library kernels give those at bf16 precision). Imported here: ops
        # imports this module.
        from ..ops.cuda_norm import batch_norm_backward

        grad_x, grad_w, grad_b = batch_norm_backward(grad_y, x.contiguous(), weight, mean, invstd,
                                                     need_x)
        return grad_x, grad_w if need_w else None, grad_b if need_b else None, None, None, None


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` (same parameters, buffers and eval forward) whose
    train forward is flax's: batch moments E[x] and E[x^2] - E[x]^2 in at
    least float32, and ``running = (1 - momentum) * running + momentum * batch``
    with the biased batch variance. The output keeps ``x``'s dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        dims = (0, 2, 3)
        # at least float32, as flax's force_float32_reductions (float64 x:
        # float64 moments, so a float64 model is a reference)
        stats = torch.promote_types(x.dtype, torch.float32)
        with torch.no_grad():
            mean = x.mean(dims, dtype=stats)
            var = (x.to(stats).square().mean(dims) - mean * mean).clamp_(min=0.0)
            self._track(mean, var)
        return _NormalizeWithStats.apply(x, self.weight, self.bias, mean, var, self.eps)

    @torch.no_grad()
    def _track(self, mean: torch.Tensor, var: torch.Tensor) -> None:
        """Move the running statistics towards ``mean`` and the biased
        ``var`` (not inside ``frozen_running_stats``)."""
        if getattr(_recompute, "active", False):
            return
        keep = 1.0 - self.momentum
        self.running_mean.copy_(keep * self.running_mean + self.momentum * mean)
        self.running_var.copy_(keep * self.running_var + self.momentum * var)
        self.num_batches_tracked.add_(1)


class _SyncNormalize(torch.autograd.Function):
    """``_NormalizeWithStats`` with ``mean`` and ``var`` the moments of the
    batch over every process of ``group`` (``count`` elements a channel):
    the backward all-reduces the sums that the moments' gradient needs,
    sum(dy) and sum(dy * (x - mean)), in at least float32. The weight's and
    the bias's gradients are this process's sums (the train step averages
    parameter gradients over the processes)."""

    @staticmethod
    def forward(ctx, x, weight, bias, mean, var, eps, count, group):
        y = torch.ops.aten.native_batch_norm(x, weight, bias, mean, var, False, 0.0, eps)[0]
        ctx.save_for_backward(x, weight, mean, torch.rsqrt(var + eps))
        ctx.count, ctx.group = count, group
        return y

    @staticmethod
    def backward(ctx, grad_y):
        x, weight, mean, invstd = ctx.saved_tensors
        need_x, need_w, need_b = ctx.needs_input_grad[:3]
        from ..ops.cuda_norm import batch_norm_grad_x, batch_norm_sums

        dy, xmu, sum_dy, sum_dy_xmu = batch_norm_sums(grad_y, x, mean)
        grad_w = sum_dy_xmu * invstd if need_w else None
        grad_b = sum_dy.clone() if need_b else None
        grad_x = None
        if need_x:
            sums = torch.cat([sum_dy, sum_dy_xmu])
            dist.all_reduce(sums, group=ctx.group)
            mean_dy, mean_dy_xmu = (sums / ctx.count).chunk(2)
            grad_x = batch_norm_grad_x(dy, xmu, mean_dy, mean_dy_xmu, weight, invstd, x.dtype)
        return grad_x, grad_w, grad_b, None, None, None, None, None


class SyncBatchNorm2d(BatchNorm2d):
    """``BatchNorm2d`` whose train moments are those of the batch over every
    process of ``group`` (default: the default group), as flax's
    ``nn.BatchNorm`` over a batch sharded across devices: E[x] and E[x^2] -
    E[x]^2 from float32 sums all-reduced in one call, the running variance
    moved towards the biased one. ``nn.SyncBatchNorm`` is not this: its
    running variance is the unbiased one and it reduces in another order.
    Eval mode is ``nn.BatchNorm2d``'s."""

    def __init__(self, *args, group=None, **kwargs):
        super().__init__(*args, **kwargs)
        self.group = group

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return nn.BatchNorm2d.forward(self, x)
        dims, c = (0, 2, 3), x.shape[1]
        stats = torch.promote_types(x.dtype, torch.float32)
        with torch.no_grad():
            local = torch.cat([x.sum(dims, dtype=stats), x.to(stats).square().sum(dims),
                               torch.full((1,), x.numel() // c, dtype=stats, device=x.device)])
            dist.all_reduce(local, group=self.group)
            count = local[-1]
            mean = local[:c] / count
            var = (local[c:2 * c] / count - mean * mean).clamp_(min=0.0)
            self._track(mean, var)
        return _SyncNormalize.apply(x, self.weight, self.bias, mean, var, self.eps, count, self.group)


def batch_norm(channels: int) -> BatchNorm2d:
    """Flax's train-mode BatchNorm (momentum 0.9 in flax's convention, eps
    1e-5) over the batch a process sees; ``convert_batch_norm`` gives a
    net another statistics scope."""
    return BatchNorm2d(channels, eps=BN_EPS, momentum=BN_MOMENTUM)


def convert_batch_norm(module: nn.Module, bn_groups: int = 1, world_size: int = 1) -> nn.Module:
    """Give every ``BatchNorm2d`` of ``module`` the statistics scope of the
    JAX package's ``bn_groups`` (groups of the global batch) when the
    global batch is split over ``world_size`` processes of one data-parallel
    mesh, one shard each (see the module doc), in place: the replacements
    take over the parameters and buffers, so the state dict is unchanged.
    ``bn_groups`` 1 in one process changes nothing. Raises when
    ``bn_groups`` > 1 does not split evenly over the processes."""
    if bn_groups <= 1:
        if world_size == 1:
            return module

        def make(bn):
            return SyncBatchNorm2d(bn.num_features, eps=bn.eps, momentum=bn.momentum)
    else:
        if bn_groups % world_size:
            raise ValueError(f"bn_groups {bn_groups} does not split over {world_size} processes")
        from ..parallel.sync_bn import LocalBatchNorm

        def make(bn):
            return LocalBatchNorm(bn.num_features, num_groups=bn_groups // world_size, eps=bn.eps,
                                  momentum=bn.momentum)
    for parent in list(module.modules()):
        for name, child in list(parent.named_children()):
            if type(child) is BatchNorm2d:
                new = make(child)
                new.weight, new.bias = child.weight, child.bias
                for buf in ("running_mean", "running_var", "num_batches_tracked"):
                    setattr(new, buf, getattr(child, buf))
                new.train(child.training)
                setattr(parent, name, new)
    return module
