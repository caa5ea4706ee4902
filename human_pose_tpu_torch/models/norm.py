"""BatchNorm for the port's models.

The JAX package's ``batch_norm`` uses flax momentum 0.9 / eps 1e-5, i.e. the
torch defaults. Inference runs in eval mode, so the running statistics are
what matters; the per-device ``LocalBatchNorm`` variant belongs with training.
"""

from __future__ import annotations

from torch import nn

BN_MOMENTUM = 0.1  # torch convention (flax 0.9)
BN_EPS = 1e-5


def batch_norm(channels: int) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(channels, eps=BN_EPS, momentum=BN_MOMENTUM)
