"""Per-group ("local") BatchNorm (port of human_pose_tpu/parallel/sync_bn.py).

The reference trains with per-device BatchNorm statistics by default
(src/base/model.py:42-44). The JAX package reproduces that over a batch
sharded across devices by splitting the batch into ``num_groups`` groups,
each normalized with its own moments. ``LocalBatchNorm`` does the same over
the batch one process sees: ``models/norm.py::convert_batch_norm`` uses it
for per-process statistics (one group over a process's shard), and one
process with ``bn_groups`` g > 1 is the JAX package's model exactly.

Running statistics move towards the mean over groups of each group's mean
and biased variance (equal in expectation to any one device's; eval uses the
running statistics either way)."""

from __future__ import annotations

import torch
from torch import nn

from ..models.norm import BatchNorm2d, _NormalizeWithStats


class LocalBatchNorm(BatchNorm2d):
    """``BatchNorm2d`` (the same parameters, buffers and eval forward) whose
    train forward splits the batch into ``num_groups`` consecutive groups
    and normalizes each with its own moments, as the JAX module: the mean
    and the two-pass biased variance in at least float32, then
    ``BatchNorm2d``'s normalization and backward kernels with those moments
    (the groups side by side as channels: one copy in and one out for more
    than one group, none for one), cast back to ``x``'s dtype."""

    def __init__(self, num_features: int, num_groups: int = 1, **kwargs):
        super().__init__(num_features, **kwargs)
        self.num_groups = num_groups

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return nn.BatchNorm2d.forward(self, x)
        n, c, h, w = x.shape
        g = self.num_groups
        if n % g:
            raise ValueError(f"batch {n} not divisible by {g} groups")
        if g > 1:  # [n / g, g * c, h, w]: group i's channel j at i * c + j
            x = x.reshape(g, n // g, c, h, w).transpose(0, 1).reshape(n // g, g * c, h, w)
        dims = (0, 2, 3)
        with torch.no_grad():
            xf = x.to(torch.promote_types(x.dtype, torch.float32))
            mean = xf.mean(dims)
            var = (xf - mean[:, None, None]).square_().mean(dims)
            self._track(mean.view(g, c).mean(0), var.view(g, c).mean(0))
        weight, bias = (self.weight, self.bias) if g == 1 else (self.weight.repeat(g), self.bias.repeat(g))
        y = _NormalizeWithStats.apply(x, weight, bias, mean, var, self.eps)
        if g > 1:
            y = y.reshape(n // g, g, c, h, w).transpose(0, 1).reshape(n, c, h, w)
        return y
