"""The PyTorch port's weights bridge and HigherHRNet forward vs the JAX package.

Inputs and weights are made with numpy from a seed and fed to both
frameworks; the port runs on the CPU in float32.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from human_pose_tpu import constants as jax_constants
from human_pose_tpu.models import HigherHRNet as JaxHigherHRNet
from human_pose_tpu.ops.images import prep_images as jax_prep_images
from human_pose_tpu.utils import torch_interop
from human_pose_tpu_torch import constants
from human_pose_tpu_torch.models import HigherHRNet
from human_pose_tpu_torch.ops import prep_images
from human_pose_tpu_torch.utils import weights

SHALLOW = dict(num_blocks_per_stage=(1, 1, 1, 1), num_units=1, num_deconv_resid_blocks=1)
FIXTURE = "tests/data/ap_fixture_weights.npz"


def _randomize(tree: dict, rs: np.random.RandomState) -> dict:
    """Random values for every leaf (BN running variances positive), so a
    swapped mapping cannot hide behind (1, 0) BN defaults."""
    return {
        k: _randomize(v, rs) if isinstance(v, dict) else (
            (0.5 + rs.rand(*v.shape)) if k == "var" else 0.3 * rs.randn(*v.shape)
        ).astype(np.float32)
        for k, v in tree.items()
    }


@pytest.fixture(scope="module")
def shallow():
    """Shallow C=8 flax HigherHRNet with random params and BN statistics."""
    model = JaxHigherHRNet(num_kpts=17, C=8, s2d=False, **SHALLOW)
    template = jax.eval_shape(
        lambda: model.init(jax.random.PRNGKey(0), np.zeros((1, 64, 64, 3), np.float32), train=False)
    )
    template = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), dict(template))
    rs = np.random.RandomState(0)
    variables = {col: _randomize(tree, rs) for col, tree in template.items()}
    return model, variables


def _to_tensors(sd: dict) -> dict:
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}


def test_variables_to_torch_matches_jax(shallow):
    _, variables = shallow
    want = torch_interop.variables_to_torch(variables)
    got = weights.variables_to_torch(variables)
    assert got.keys() == want.keys()
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_state_dict_loads_strict(shallow):
    _, variables = shallow
    net = HigherHRNet(num_kpts=17, C=8, device="cpu", **SHALLOW)
    result = net.load_state_dict(_to_tensors(weights.variables_to_torch(variables)), strict=True)
    assert not result.missing_keys and not result.unexpected_keys


def test_fixture_npz_loads_strict():
    """The committed JAX-trained fixture weights (C=8, full depth) carry
    across through ``load_flax_npz``."""
    sd = weights.load_flax_npz(FIXTURE)
    net = HigherHRNet(num_kpts=17, C=8, device="cpu")
    net.load_state_dict(_to_tensors(sd), strict=True)
    with np.load(FIXTURE) as z:
        kernel = z["params/backbone/stem1/conv/kernel"].astype(np.float32)
    np.testing.assert_array_equal(net.backbone.conv1.weight.detach().numpy(), kernel.transpose(3, 2, 0, 1))


def test_w32_param_count():
    net = HigherHRNet(num_kpts=17, C=32, device="cpu")
    assert sum(p.numel() for p in net.parameters()) == 28_645_331


def test_torch_key_for_rejects_unknown_path():
    with pytest.raises(KeyError):
        weights.torch_key_for(("nonexistent", "conv"))


def test_strip_torch_prefixes():
    sd = {"module._orig_mod.net.backbone.conv1.weight": 1, "deconv_layers.0.final_layer.bias": 2}
    assert weights.strip_torch_prefixes(sd) == {
        "backbone.conv1.weight": 1, "deconv_layers.0.final_layer.bias": 2,
    }


def test_forward_matches_flax(shallow):
    """fp32 CPU outputs of both heatmap stages and the tags match flax
    (plain layout) to a max relative error < 2e-4: the two frameworks sum
    the convolutions in different orders, nothing more."""
    model, variables = shallow
    x = np.random.RandomState(1).randn(2, 64, 64, 3).astype(np.float32)
    hms_j, tags_j = model.apply(variables, x, train=False)

    net = HigherHRNet(num_kpts=17, C=8, device="cpu", **SHALLOW).eval()
    net.load_state_dict(_to_tensors(weights.variables_to_torch(variables)))
    with torch.no_grad():
        hms_t, tags_t = net(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()))

    assert len(hms_t) == 2
    for want, got in zip([*hms_j, tags_j], [*hms_t, tags_t]):
        want = np.asarray(want).transpose(0, 3, 1, 2)
        assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
        rel = np.abs(got.numpy() - want).max() / max(np.abs(want).max(), 1e-3)
        assert rel < 2e-4


def test_constants_match_jax():
    for name in ("IMAGENET_MEAN", "IMAGENET_STD", "PAD_PIXEL_U8"):
        assert getattr(constants, name) == getattr(jax_constants, name), name


def test_prep_images_matches_jax():
    """uint8 NCHW images normalize like the JAX package's NHWC path (the same
    float32 operations; 1e-6 covers XLA rewriting /255 as a multiply by its
    reciprocal); float images pass through; ``out_dtype`` casts."""
    u8 = np.random.RandomState(2).randint(0, 256, (2, 16, 24, 3)).astype(np.uint8)
    want = np.asarray(jax_prep_images(jnp.asarray(u8))).transpose(0, 3, 1, 2)
    x = torch.from_numpy(u8.transpose(0, 3, 1, 2).copy())
    got = prep_images(x)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    assert prep_images(got) is got
    assert prep_images(x, out_dtype=torch.bfloat16).dtype == torch.bfloat16
