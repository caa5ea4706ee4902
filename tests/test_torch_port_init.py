"""``init_flax_default_``'s conv and transposed-conv draws against flax's
``nn.Conv`` / ``nn.ConvTranspose`` default (LeCun normal truncated to 2 std),
on HigherHRNet-W32's own layers: a 3x3 conv of the first branch and the
deconv head's transposed conv.

The draws must have flax's std (within 3%: 4096 draws or more leave about
1.1% of sampling noise) and no point mass at the truncation bound: a clamp
of the normal at 2 std instead of a truncated draw puts 4.6% of the values
on +-2 std / 0.8796 and widens the std by 9%.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from human_pose_tpu_torch.models import HigherHRNet, init_flax_default_
from human_pose_tpu_torch.models.init import TRUNCATED_NORMAL_STD
from tests.jax_reference import light_jax_reference  # noqa: F401  (module fixture)


@pytest.fixture(scope="module")
def w32():
    net = HigherHRNet(num_kpts=17, C=32, device="cpu")
    return init_flax_default_(net, torch.Generator().manual_seed(0))


def _jax_kernel(layer, x_shape) -> np.ndarray:
    """flax's default kernel draw for ``layer`` (HWIO), applied to NHWC."""
    params = layer.init(jax.random.PRNGKey(0), jnp.zeros(x_shape))["params"]
    return np.asarray(params["kernel"])


def _layers(net):
    """(name, port module, flax layer, NHWC input shape) of the two layers."""
    conv = next(m for m in net.backbone.modules()
                if isinstance(m, torch.nn.Conv2d) and m.weight.shape == (32, 32, 3, 3))
    deconv = net.deconv_layers[0].deconv[0]
    assert isinstance(deconv, torch.nn.ConvTranspose2d)
    cin, cout, kh, kw = deconv.weight.shape
    return [
        ("3x3 conv", conv, fnn.Conv(32, (3, 3), use_bias=False), (1, 8, 8, 32)),
        ("deconv", deconv, fnn.ConvTranspose(cout, (kh, kw), strides=(2, 2), use_bias=False),
         (1, 8, 8, cin)),
    ]


@pytest.mark.parametrize("which", [0, 1], ids=["conv3x3", "deconv"])
def test_default_init_matches_flax_conv_default(w32, which):
    name, module, layer, x_shape = _layers(w32)[which]
    w = module.weight.detach().numpy().astype(np.float64)
    assert w.size >= 4096, name
    # fan_in: in_channels * kH * kW (a transposed conv's in_channels is dim 0)
    cin = w.shape[0] if isinstance(module, torch.nn.ConvTranspose2d) else w.shape[1]
    want = 1.0 / math.sqrt(cin * w.shape[2] * w.shape[3])
    jax_w = _jax_kernel(layer, x_shape)
    assert jax_w.size == w.size, name
    assert abs(jax_w.std() / want - 1) <= 0.03, name  # flax's draw itself
    assert abs(w.std() / want - 1) <= 0.03, (name, w.std() / want)
    assert abs(w.std() / jax_w.std() - 1) <= 0.03, (name, w.std() / jax_w.std())
    # the truncation bound: nothing past it, and no point mass on it (a
    # continuous draw puts ~1e-7 of its values within 1e-6 of the bound)
    limit = 2.0 * want / TRUNCATED_NORMAL_STD
    a = np.abs(w)
    assert a.max() <= limit * (1 + 1e-6), name
    on_bound = int((a >= limit * (1 - 1e-6)).sum())
    assert on_bound <= 1, (name, on_bound, w.size)
    assert abs(w.mean()) <= 4 * want / math.sqrt(w.size), name


def test_default_init_keeps_zero_biases_and_bn(w32):
    """Conv biases 0 (the 1x1 heads carry one), BN at (1, 0) with unit
    running variance."""
    n_bias = 0
    for m in w32.modules():
        if isinstance(m, (torch.nn.Conv2d, torch.nn.ConvTranspose2d)) and m.bias is not None:
            assert not m.bias.any()
            n_bias += 1
        elif isinstance(m, torch.nn.BatchNorm2d):
            assert bool((m.weight == 1).all()) and not m.bias.any()
            assert bool((m.running_var == 1).all()) and not m.running_mean.any()
    assert n_bias >= 2
