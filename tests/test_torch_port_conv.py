"""The port's fused BasicBlock (plain path, CPU) and BN folding vs the JAX
package (``human_pose_tpu/ops/pallas_conv.py``, the Pallas kernel in
interpret mode), and the fold carried across the weight bridge.

Both frameworks sum the convolutions in their own orders, so block outputs
agree to 1e-4, the JAX package's own bound (``tests/test_pallas_conv.py``);
the folded weights are the same float32 operations on the same values, held
to 1e-6.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from human_pose_tpu.models import HigherHRNet as JaxHigherHRNet
from human_pose_tpu.ops.pallas_conv import (
    fold_conv_bn as jax_fold_conv_bn,
    fused_basic_block as jax_fused_basic_block,
    reference_basic_block as jax_reference_basic_block,
)
from human_pose_tpu_torch.models import HigherHRNet
from human_pose_tpu_torch.ops import (
    fold_basic_block, fold_conv_bn, fused_basic_block, fused_basic_block_plain,
    reference_basic_block,
)
from human_pose_tpu_torch.utils import weights
from tests.test_torch_port_models import SHALLOW, _randomize, _to_tensors


def _block_params(shape, seed=0):
    rng = np.random.RandomState(seed)
    b, h, w, c = shape
    return (rng.randn(*shape).astype(np.float32) * 0.5,
            rng.randn(3, 3, c, c).astype(np.float32) * 0.1, rng.randn(c).astype(np.float32) * 0.1,
            rng.randn(3, 3, c, c).astype(np.float32) * 0.1, rng.randn(c).astype(np.float32) * 0.1)


@pytest.mark.parametrize("shape", [(1, 16, 16, 8), (2, 32, 24, 16)])
def test_fused_block_matches_jax(shape):
    arrays = _block_params(shape)
    want = np.asarray(jax_fused_basic_block(*map(jnp.asarray, arrays), interpret=True))
    tensors = [torch.from_numpy(a) for a in arrays]
    got = fused_basic_block(*tensors)
    assert got.dtype == torch.float32 and tuple(got.shape) == shape and got.is_contiguous()
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)
    ref = np.asarray(jax_reference_basic_block(*map(jnp.asarray, arrays)))
    np.testing.assert_allclose(reference_basic_block(*tensors).numpy(), ref, rtol=0, atol=1e-4)


def test_fused_block_bf16_casts_the_intermediate():
    """bf16 input: the output is bf16, the intermediate activation is
    rounded to bf16 before the second convolution (as the Pallas kernel
    does), which the float32 reference does not; both stay within bf16
    rounding of the float32 block."""
    x, w1, b1, w2, b2 = [torch.from_numpy(a) for a in _block_params((2, 16, 8, 16), seed=1)]
    xb = x.to(torch.bfloat16)
    got = fused_basic_block(xb, w1, b1, w2, b2)
    assert got.dtype == torch.bfloat16
    ref = reference_basic_block(xb.float(), w1, b1, w2, b2)
    scale = float(ref.abs().max())
    assert float((got.float() - ref).abs().max()) <= 2 ** -6 * scale
    y = torch.relu(torch.nn.functional.conv2d(xb.float().permute(0, 3, 1, 2), w1.permute(3, 2, 0, 1), b1,
                                              padding=1))
    assert not torch.equal(y, y.to(torch.bfloat16).float())  # the cast is not a no-op here
    assert torch.equal(got, fused_basic_block_plain(xb, w1, b1, w2, b2))


def test_fused_block_rejects_bad_shapes():
    x, w1, b1, w2, b2 = [torch.from_numpy(a) for a in _block_params((1, 8, 8, 8))]
    with pytest.raises(ValueError, match="shape"):
        fused_basic_block(x, w1[:, :, :4], b1, w2, b2)
    with pytest.raises(ValueError, match="shape"):
        fused_basic_block(x, w1, b1[:4], w2, b2)


@pytest.fixture(scope="module")
def shallow_flax():
    """Shallow C=8 flax HigherHRNet with random params and BN statistics."""
    model = JaxHigherHRNet(num_kpts=17, C=8, s2d=False, **SHALLOW)
    template = jax.eval_shape(
        lambda: model.init(jax.random.PRNGKey(0), np.zeros((1, 64, 64, 3), np.float32), train=False)
    )
    template = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), dict(template))
    rs = np.random.RandomState(0)
    return {col: _randomize(tree, rs) for col, tree in template.items()}


@pytest.mark.parametrize("scale", [0, 2])
def test_fold_carried_across_matches_jax(shallow_flax, scale):
    """A stage-3 BasicBlock of the flax net: JAX's fold of its params vs the
    port's fold of the same params after the weight bridge (1e-6), and the
    port's fused block on them vs JAX's reference block and vs the port
    block's own eval forward (1e-4)."""
    unit = f"backbone/stage3/block0/scale{scale}_unit0"
    params, stats = shallow_flax["params"], shallow_flax["batch_stats"]

    def node(tree, path):
        for key in path.split("/"):
            tree = tree[key]
        return tree

    folded_jax = []
    for cb in ("cb1", "cb2"):
        p, s = node(params, f"{unit}/{cb}"), node(stats, f"{unit}/{cb}/bn")
        folded_jax += jax_fold_conv_bn(jnp.asarray(p["conv"]["kernel"]), jnp.asarray(p["bn"]["scale"]),
                                       jnp.asarray(p["bn"]["bias"]), jnp.asarray(s["mean"]),
                                       jnp.asarray(s["var"]))

    net = HigherHRNet(num_kpts=17, C=8, device="cpu", **SHALLOW).eval()
    net.load_state_dict(_to_tensors(weights.variables_to_torch(shallow_flax)), strict=True)
    block = net.backbone.stages[2].blocks[0].scales_blocks[scale][0]
    folded = fold_basic_block(block)
    for got, want in zip(folded, folded_jax):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)

    c = folded[0].shape[-1]
    x = np.random.RandomState(scale).rand(2, 16, 12, c).astype(np.float32)  # post-ReLU-like input
    want = np.asarray(jax_reference_basic_block(jnp.asarray(x), *folded_jax))
    got = fused_basic_block(torch.from_numpy(x), *folded)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)
    with torch.no_grad():
        eval_out = block(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), eval_out.numpy(), rtol=0, atol=1e-4)


def test_fold_conv_bn_matches_jax():
    rng = np.random.RandomState(1)
    c = 8
    args = (rng.randn(3, 3, c, c).astype(np.float32) * 0.1, rng.rand(c).astype(np.float32) + 0.5,
            rng.randn(c).astype(np.float32), rng.randn(c).astype(np.float32),
            rng.rand(c).astype(np.float32) + 0.1)
    for got, want in zip(fold_conv_bn(*map(torch.from_numpy, args)),
                         jax_fold_conv_bn(*map(jnp.asarray, args))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)


def test_fold_basic_block_refuses_downsample():
    from human_pose_tpu_torch.models.hrnet import BasicBlock

    with pytest.raises(ValueError, match="downsample"):
        fold_basic_block(BasicBlock(8, 16))
