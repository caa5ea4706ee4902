"""BatchNorm for the port's models (port of human_pose_tpu/models/norm.py at
``bn_groups`` 1; the per-device ``LocalBatchNorm`` belongs with the
parallel slice).

The JAX package's ``batch_norm`` is flax's ``nn.BatchNorm`` at momentum 0.9,
eps 1e-5. In eval mode it normalizes with the running statistics, as
``nn.BatchNorm2d`` does. In train mode the two differ:

* flax takes the batch variance as E[x^2] - E[x]^2, clipped at 0, both
  moments in float32 (``use_fast_variance``, ``force_float32_reductions``);
* flax moves ``running_var`` towards that biased variance; ``nn.BatchNorm2d``
  moves it towards the unbiased one, n / (n - 1) times larger.

``BatchNorm2d`` below keeps ``nn.BatchNorm2d``'s eval path and its
state-dict keys and does flax's train step.
"""

from __future__ import annotations

import torch
from torch import nn

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
        grad_x, grad_w, grad_b = torch.ops.aten.native_batch_norm_backward(
            grad_y.contiguous(), x, weight, None, None, mean, invstd, True, ctx.eps,
            list(ctx.needs_input_grad[:3]))
        return grad_x, grad_w, grad_b, None, None, None


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` (same parameters, buffers and eval forward) whose
    train forward is flax's: batch moments E[x] and E[x^2] - E[x]^2 in
    float32, and ``running = (1 - momentum) * running + momentum * batch``
    with the biased batch variance. The output keeps ``x``'s dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        dims = (0, 2, 3)
        with torch.no_grad():
            mean = x.mean(dims, dtype=torch.float32)
            var = (x.float().square().mean(dims) - mean * mean).clamp_(min=0.0)
            keep = 1.0 - self.momentum
            self.running_mean.copy_(keep * self.running_mean + self.momentum * mean)
            self.running_var.copy_(keep * self.running_var + self.momentum * var)
            self.num_batches_tracked.add_(1)
        return _NormalizeWithStats.apply(x, self.weight, self.bias, mean, var, self.eps)


def batch_norm(channels: int) -> BatchNorm2d:
    return BatchNorm2d(channels, eps=BN_EPS, momentum=BN_MOMENTUM)
