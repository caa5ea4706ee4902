"""The port's fused BasicBlock (plain path, CPU) and BN folding vs the JAX
package (``human_pose_tpu/ops/pallas_conv.py``, the Pallas kernel in
interpret mode), and the fold carried across the weight bridge.

Both frameworks sum the convolutions in their own orders, so block outputs
agree to 1e-4, the JAX package's own bound (``tests/test_pallas_conv.py``);
the folded weights are the same float32 operations on the same values, held
to 1e-6. With bfloat16 input and weights the intermediate activation is
rounded to bfloat16, and a value at a rounding boundary can round either
way under another summation order: 2**-6 of the output scale.

On the card the float32 block runs as 3xTF32 (each operand split into a
TF32 high part and the rest, three TF32 products a term); its split, its
packed weights and its arithmetic, emulated in float64, are checked here.
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
from human_pose_tpu_torch.ops.cuda_conv import (
    chunk_channels, fused_basic_block_packed, pack_block_weights, padded_channels, tf32_split,
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


@pytest.mark.parametrize("shape", [(1, 16, 16, 16), (2, 8, 12, 12)])
def test_fused_block_bf16_weights_matches_jax(shape):
    """bf16 x and bf16 weights (float32 biases): the port's plain block vs
    the Pallas kernel in interpret mode, whose tap matmuls take bf16 x bf16
    into float32."""
    x, w1, b1, w2, b2 = _block_params(shape, seed=2)
    xb, w1b, w2b = (jnp.asarray(a, jnp.bfloat16) for a in (x, w1, w2))
    want = np.asarray(jax_fused_basic_block(xb, w1b, jnp.asarray(b1), w2b, jnp.asarray(b2),
                                            interpret=True).astype(jnp.float32))
    to_t = lambda a: torch.from_numpy(np.array(a.astype(jnp.float32))).to(torch.bfloat16)  # noqa: E731
    got = fused_basic_block(to_t(xb), to_t(w1b), torch.from_numpy(b1), to_t(w2b), torch.from_numpy(b2))
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == shape
    assert float(np.abs(got.float().numpy() - want).max()) <= 2 ** -6 * float(np.abs(want).max())


def test_fused_block_plain_rounds_weights_for_bf16_only():
    """bf16 x: the plain block multiplies bf16-rounded weights (biases stay
    float32); float32 x: the weights are used as they are."""
    x, w1, b1, w2, b2 = [torch.from_numpy(a) for a in _block_params((2, 8, 8, 16), seed=3)]
    r1, r2 = (w.to(torch.bfloat16).to(torch.float32) for w in (w1, w2))
    assert not torch.equal(r1, w1)
    xb = x.to(torch.bfloat16)
    assert torch.equal(fused_basic_block_plain(xb, w1, b1, w2, b2), fused_basic_block_plain(xb, r1, b1, r2, b2))
    assert torch.equal(fused_basic_block_plain(x, w1, b1, w2, b2), reference_basic_block(x, w1, b1, w2, b2))
    assert not torch.equal(fused_basic_block_plain(x, w1, b1, w2, b2), fused_basic_block_plain(x, r1, b1, r2, b2))


@pytest.mark.parametrize("c", [12, 32, 48, 128])
def test_pack_block_weights_layout(c):
    """The packed weights unpack to the bf16 HWIO weights, padded channels
    are zero, each element sits where the kernel's descriptors read it, and
    the biases are laid out [b1; b2] with zeros past C."""
    rng = np.random.RandomState(c)
    w1, w2 = (torch.from_numpy(rng.randn(3, 3, c, c).astype(np.float32)) for _ in range(2))
    b1, b2 = (torch.from_numpy(rng.randn(c).astype(np.float32)) for _ in range(2))
    wpack, bias = pack_block_weights(w1, b1, w2, b2)
    cp, kch = padded_channels(c), chunk_channels(padded_channels(c))
    assert wpack.dtype == torch.bfloat16 and wpack.numel() == 2 * 9 * cp * cp
    # unpack: [conv, tap, kc, ks, ng, kh, n8, k8] -> [conv, tap, ci, co]
    w = wpack.reshape(2, 9, cp // kch, kch // 16, cp // 8, 2, 8, 8).permute(0, 1, 2, 3, 5, 7, 4, 6)
    w = w.reshape(2, 3, 3, cp, cp)
    assert torch.equal(w[0, ..., :c, :c], w1.to(torch.bfloat16))
    assert torch.equal(w[1, ..., :c, :c], w2.to(torch.bfloat16))
    assert int((wpack != 0).sum()) == int((w1 != 0).sum() + (w2 != 0).sum())
    for conv, w in enumerate((w1, w2)):
        for tap, ci, co in ((0, 0, 0), (4, c - 1, c - 2), (8, c // 2 + 1, c // 3), (7, 9, c - 1)):
            kc, k = divmod(ci, kch)
            ks, kk = divmod(k, 16)
            ng, n8 = divmod(co, 8)
            chunk = (conv * 9 + tap) * (cp // kch) + kc
            off = chunk * kch * cp + ((ks * (cp // 8) + ng) * 2 + kk // 8) * 64 + n8 * 8 + kk % 8
            assert wpack[off] == w.reshape(9, c, c)[tap, ci, co].to(torch.bfloat16)
    assert torch.equal(bias[0, :c], b1) and torch.equal(bias[1, :c], b2) and not bias[:, c:].any()


def _tf32_reference(w: np.ndarray) -> np.ndarray:
    """float32 -> TF32 by magnitude and sign: round to nearest at mantissa
    bit 13, ties away from zero (``cvt.rna.tf32.f32``)."""
    u = w.astype(np.float32).view(np.uint32)
    mag = ((u & np.uint32(0x7FFFFFFF)) + np.uint32(0x1000)) & np.uint32(0xFFFFE000)
    return (mag | (u & np.uint32(0x80000000))).view(np.float32)


def _tf32_truncate(t: torch.Tensor) -> torch.Tensor:
    """What the tensor cores take of a float32 operand: its low 13 mantissa
    bits cleared."""
    return (t.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def _split_inputs(kind: str) -> np.ndarray:
    rng = np.random.RandomState(7)
    if kind == "random":
        return (rng.randn(4096) * 10.0 ** rng.uniform(-30, 30, 4096)).astype(np.float32)
    if kind == "subnormal":  # exponent field 0, random mantissas and signs
        bits = rng.randint(1, 1 << 23, 4096).astype(np.uint32) | (rng.randint(0, 2, 4096).astype(np.uint32) << 31)
        return bits.view(np.float32)
    if kind == "large":
        return (rng.choice([-1.0, 1.0], 4096) * rng.uniform(1e37, 3e38, 4096)).astype(np.float32)
    # ties: the low 13 mantissa bits exactly half a TF32 ulp, random exponents and signs
    bits = (rng.randint(1, 254, 4096).astype(np.uint32) << 23) | (rng.randint(0, 1 << 10, 4096).astype(np.uint32) << 13)
    bits |= np.uint32(0x1000) | (rng.randint(0, 2, 4096).astype(np.uint32) << 31)
    return bits.view(np.float32)


@pytest.mark.parametrize("kind", ["random", "subnormal", "large", "ties"])
def test_tf32_split(kind):
    """``hi`` is TF32 (low 13 mantissa bits zero), equals a NumPy rounding to
    nearest with ties away from zero, and ``hi + lo == w`` exactly."""
    w = _split_inputs(kind)
    hi, lo = tf32_split(torch.from_numpy(w))
    assert hi.dtype == lo.dtype == torch.float32
    assert not (hi.view(torch.int32) & 0x1FFF).any()
    assert np.array_equal(hi.numpy().view(np.uint32), _tf32_reference(w).view(np.uint32))
    assert torch.equal(hi.double() + lo.double(), torch.from_numpy(w).double())
    assert torch.equal(hi + lo, torch.from_numpy(w))
    if kind == "ties":  # every value rounds away from zero
        assert bool((hi.abs() > torch.from_numpy(w).abs()).all())


@pytest.mark.parametrize("c", [4, 12, 32, 48, 64, 128, 256])
def test_pack_block_weights_f32_layout(c):
    """The float32 pack unpacks to the TF32 high and low HWIO weights,
    padded channels are zero, each element sits where the kernel's
    descriptors read it (k8 step, part, output-channel group, input-channel
    half, n8, k4), and the biases are laid out [b1; b2] with zeros past C."""
    rng = np.random.RandomState(c + 1)
    w1, w2 = (torch.from_numpy(rng.randn(3, 3, c, c).astype(np.float32)) for _ in range(2))
    b1, b2 = (torch.from_numpy(rng.randn(c).astype(np.float32)) for _ in range(2))
    wpack, bias = pack_block_weights(w1, b1, w2, b2, dtype=torch.float32)
    cp = padded_channels(c)
    assert wpack.dtype == torch.float32 and wpack.numel() == 2 * 9 * cp * cp * 2
    # unpack: [conv, tap, ks, part, ng, kh, n8, k4] -> [conv, part, tap, ci, co]
    w = wpack.reshape(2, 9, cp // 8, 2, cp // 8, 2, 8, 4).permute(0, 3, 1, 2, 5, 7, 4, 6)
    w = w.reshape(2, 2, 3, 3, cp, cp)
    for conv, wc in enumerate((w1, w2)):
        hi, lo = tf32_split(wc)
        assert torch.equal(w[conv, 0, ..., :c, :c], hi) and torch.equal(w[conv, 1, ..., :c, :c], lo)
        assert not w[conv, :, :, :, c:].any() and not w[conv, ..., c:].any()
    for conv, wc in enumerate((w1, w2)):
        hi, lo = tf32_split(wc.reshape(9, c, c))
        for tap, ci, co in ((0, 0, 0), (4, c - 1, c - 2), (8, c // 2 + 1, c // 3), (7, 3, c - 1)):
            ks, k = divmod(ci, 8)
            kh, k4 = divmod(k, 4)
            ng, n8 = divmod(co, 8)
            for part, want in enumerate((hi, lo)):
                off = ((((conv * 9 + tap) * (cp // 8) + ks) * 2 + part) * 8 * cp
                       + (ng * 2 + kh) * 32 + n8 * 4 + k4)
                assert wpack[off] == want[tap, ci, co]
    assert torch.equal(bias[0, :c], b1) and torch.equal(bias[1, :c], b2) and not bias[:, c:].any()


def _tf32_products(x_nchw: torch.Tensor, w_hwio: torch.Tensor, products: int) -> torch.Tensor:
    """conv3x3 (SAME) in float64 as the tensor cores take it: the float32
    operands split by ``tf32_split``, the low parts truncated to TF32;
    ``products`` 3 is lo*hi + hi*lo + hi*hi, 1 is hi*hi alone."""
    xh, xl = tf32_split(x_nchw)
    wh, wl = tf32_split(w_hwio.permute(3, 2, 0, 1).contiguous())
    pairs = [(xh, wh)] if products == 1 else [(_tf32_truncate(xl), wh), (xh, _tf32_truncate(wl)), (xh, wh)]
    return sum(torch.nn.functional.conv2d(a.double(), b.double(), padding=1) for a, b in pairs)


def _tf32_block(x, w1, b1, w2, b2, products):
    """The float32 kernel's arithmetic emulated on the CPU: each conv's sum
    in float64 (the card sums in float32: both far finer than 1e-4), the
    intermediate activation rounded to float32 before it is split again."""
    xf = x.permute(0, 3, 1, 2)
    y = torch.relu(_tf32_products(xf, w1, products) + b1.double()[:, None, None]).float()
    z = _tf32_products(y, w2, products) + b2.double()[:, None, None] + xf.double()
    return torch.relu(z).float().permute(0, 2, 3, 1)


@pytest.mark.parametrize("shape,products,within", [
    ((2, 16, 16, 256), 3, True), ((2, 32, 32, 32), 3, True), ((2, 16, 16, 256), 1, False)])
def test_tf32_arithmetic_emulated(shape, products, within):
    """Three TF32 products a term stay within 1e-4 of the plain float32
    block at a W32-like C = 256 and at C = 32; one product (hi * hi, plain
    TF32) does not at C = 256."""
    rng = np.random.RandomState(shape[-1])
    c = shape[-1]
    x = torch.from_numpy(rng.randn(*shape).astype(np.float32))
    w1, w2 = (torch.from_numpy((rng.randn(3, 3, c, c) / np.sqrt(9 * c)).astype(np.float32)) for _ in range(2))
    b1, b2 = (torch.from_numpy((rng.randn(c) * 0.1).astype(np.float32)) for _ in range(2))
    err = float((_tf32_block(x, w1, b1, w2, b2, products) - fused_basic_block_plain(x, w1, b1, w2, b2)).abs().max())
    assert (err <= 1e-4) == within, err


@pytest.mark.parametrize("case", ["size", "dtype", "device", "bf16_pack"])
def test_fused_block_packed_refuses_f32_pack(case):
    """A float32 pack of the wrong size, dtype or device is refused with
    ValueError before anything is launched."""
    x = torch.zeros((1, 4, 4, 32))
    wpack, bias = pack_block_weights(*(torch.zeros(s) for s in ((3, 3, 32, 32), (32,), (3, 3, 32, 32), (32,))),
                                     dtype=torch.float32)
    if case == "size":
        wpack = wpack[: wpack.numel() // 2]
    elif case == "dtype":
        wpack = wpack.double()
    elif case == "device":
        wpack = wpack.to("meta")
    else:  # the bf16 pack of the same weights
        wpack, bias = pack_block_weights(*(torch.zeros(s) for s in ((3, 3, 32, 32), (32,), (3, 3, 32, 32), (32,))))
    with pytest.raises(ValueError, match="packed weights"):
        fused_basic_block_packed(x, wpack, bias)


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
