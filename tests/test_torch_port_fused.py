"""The port's fused decode front end (plain path, CPU) vs the JAX package.

Seeded numpy inputs go through the JAX functions (Pallas kernels in
interpret mode, as ``tests/test_fused_decode.py`` runs them) and the port's
counterparts. Where both sides compute the same float32 operations the
check is exact. The one stated exception: XLA:CPU contracts some of the
interpret-mode aggregate kernel's ``0.25*a + 0.75*b`` lerps into fused
multiply-adds (at the differing positions JAX holds the singly rounded
lerp), so the JAX aggregate is a reference only to an ulp, 3e-7 on maps in
[0, 1]; the CUDA kernel equals the port's plain version bit for bit
(``tests/test_torch_port_cuda.py``).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from human_pose_tpu.ops import grouping as jg
from human_pose_tpu.ops.decode import decode_batch_fused as jax_decode_batch_fused
from human_pose_tpu.ops.pallas_aggregate import (
    fused_aggregate as jax_fused_aggregate,
    phase_gather as jax_phase_gather,
    refine_argmax_phase_batch as jax_refine_phase,
    sample_tags_bilinear as jax_sample_tags,
)
from human_pose_tpu.ops.pallas_match import match_by_tag_pallas
from human_pose_tpu_torch.ops import (
    adjust_phase, cuda_match, decode_batch, decode_batch_fused, fused_aggregate, phase_gather,
    refine_argmax_phase_batch, refine_batch_phase, sample_tags_bilinear,
)
from human_pose_tpu_torch.ops.phase import dense_to_phase, phase_to_dense
from tests.test_grouping_production import synth_scene

B, K, E, H4, W4 = 2, 3, 2, 16, 128
H, W = 4 * H4, 4 * W4
P = 6
ORDER = tuple(jg.JOINTS_ORDER)


def _t(a):
    return torch.from_numpy(np.array(a, dtype=a.dtype, copy=True))


@pytest.fixture(scope="module")
def maps():
    rs = np.random.RandomState(0)
    q = rs.rand(B, K, H4, W4).astype(np.float32)
    h2 = rs.rand(B, K, 2 * H4, 2 * W4).astype(np.float32)
    tags_lo = (rs.rand(B, K, E, H4, W4) * 4).astype(np.float32)
    prev = (rs.rand(B, P, E) * 4).astype(np.float32)
    return q, h2, tags_lo, prev


@pytest.fixture(scope="module")
def jax_aggregate(maps):
    q, h2, _, _ = maps
    return [np.asarray(a) for a in jax_fused_aggregate(jnp.asarray(q), jnp.asarray(h2), interpret=True)]


def test_fused_aggregate_matches_jax(maps, jax_aggregate):
    q, h2, _, _ = maps
    ja, js, jc = jax_aggregate
    avg, sup, cmax = fused_aggregate(_t(q), _t(h2))
    assert tuple(avg.shape) == ja.shape and tuple(cmax.shape) == jc.shape
    np.testing.assert_allclose(avg.numpy(), ja, rtol=0, atol=3e-7)
    np.testing.assert_array_equal(sup.numpy() > 0, js > 0)  # the same NMS survivors
    np.testing.assert_allclose(sup.numpy(), js, rtol=0, atol=3e-7)
    np.testing.assert_allclose(cmax.numpy(), jc, rtol=0, atol=3e-7)
    # cmax is exactly the row maxima of sup on either side
    rows = phase_to_dense(sup).amax(dim=3).reshape(B, K, H4, 4).transpose(2, 3)
    assert torch.equal(cmax, rows)
    assert torch.equal(dense_to_phase(phase_to_dense(avg)), avg)


@pytest.mark.parametrize("e", [1, 2])
def test_refine_phase_matches_jax(maps, jax_aggregate, e):
    """The same phase-layout heatmap (JAX's) into both: idx and val exact;
    sqrt of the squares at E=1 as well."""
    _, _, tags_lo, prev = maps
    avg = jax_aggregate[0]
    ji, jv = jax_refine_phase(jnp.asarray(avg), jnp.asarray(tags_lo[:, :, :e]),
                              jnp.asarray(prev[..., :e]), interpret=True)
    idx, val = refine_argmax_phase_batch(_t(avg), _t(tags_lo[:, :, :e]), _t(prev[..., :e]))
    assert idx.dtype == torch.int32 and val.dtype == torch.float32
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(val.numpy(), np.asarray(jv))


def test_refine_phase_tie_first():
    """Constant heatmap and zero tags: every position ties, 0 wins."""
    avg = np.ones((1, 2, 4, 4, 4, 8), np.float32)
    tags = np.zeros((1, 2, 1, 4, 8), np.float32)
    prev = np.zeros((1, 3, 1), np.float32)
    ji, _ = jax_refine_phase(jnp.asarray(avg), jnp.asarray(tags), jnp.asarray(prev), interpret=True)
    idx, val = refine_argmax_phase_batch(_t(avg), _t(tags), _t(prev))
    assert int(np.asarray(ji).max()) == 0 and int(idx.max()) == 0
    assert torch.equal(val, torch.ones_like(val))


def test_sample_tags_and_phase_gather_match_jax(maps, jax_aggregate):
    _, _, tags_lo, _ = maps
    rs = np.random.RandomState(3)
    ys = rs.randint(0, H, (K, 50))
    xs = rs.randint(0, W, (K, 50))
    ys[:, :4], xs[:, :4] = [0, H - 1, 0, H - 1], [0, 0, W - 1, W - 1]  # the corners
    want = np.asarray(jax_sample_tags(jnp.asarray(tags_lo[0]), jnp.asarray(ys), jnp.asarray(xs), H, W))
    got = sample_tags_bilinear(_t(tags_lo[0]), _t(ys), _t(xs))
    np.testing.assert_array_equal(got.numpy(), want)
    batched = sample_tags_bilinear(_t(tags_lo), _t(np.stack([ys, ys])), _t(np.stack([xs, xs])))
    np.testing.assert_array_equal(batched[0].numpy(), want)

    avg = jax_aggregate[0][0]  # [K, 4, 4, H4, W4]
    kk = np.broadcast_to(np.arange(K)[:, None], ys.shape)
    want = np.asarray(jax_phase_gather(jnp.asarray(avg), jnp.asarray(kk), jnp.asarray(ys), jnp.asarray(xs)))
    np.testing.assert_array_equal(phase_gather(_t(avg), _t(ys), _t(xs)).numpy(), want)


def _grouped(seed):
    """Grouped joints [B, P, K, 3+E]: integer coordinates (borders
    included), a third of the joints undetected (score 0), one person with
    no detection."""
    rs = np.random.RandomState(seed)
    g = np.zeros((B, P, K, 3 + E), np.float32)
    g[..., 0] = rs.randint(0, W, (B, P, K))
    g[..., 1] = rs.randint(0, H, (B, P, K))
    g[0, 0, :, :2] = [[0, 0], [W - 1, H - 1], [0, H - 1]][:K]
    g[..., 2] = np.where(rs.rand(B, P, K) < 0.33, 0.0, 0.1 + rs.rand(B, P, K)).astype(np.float32)
    g[1, 2, :, 2] = 0.0
    g[..., 3:] = rs.rand(B, P, K, E) * 4
    return g


def test_adjust_and_refine_phase_match_jax(maps, jax_aggregate):
    _, _, tags_lo, _ = maps
    avg = jax_aggregate[0]
    g = _grouped(1)
    want = np.asarray(jax.vmap(jg.adjust_phase)(jnp.asarray(g), jnp.asarray(avg)))
    np.testing.assert_array_equal(adjust_phase(_t(g), _t(avg)).numpy(), want)

    want = np.asarray(jg.refine_batch_phase(jnp.asarray(avg), jnp.asarray(tags_lo), jnp.asarray(g),
                                            interpret=True))
    got = refine_batch_phase(_t(avg), _t(tags_lo), _t(g)).numpy()
    np.testing.assert_array_equal(got[..., :3], want[..., :3])
    assert (got[..., 2] > g[..., 2]).any()  # some joints were filled in
    np.testing.assert_array_equal(got[1, 2], g[1, 2])  # no detection: untouched


@pytest.fixture(scope="module")
def model_outputs():
    """The JAX fused-decode test's inputs (tests/test_fused_decode.py), NHWC."""
    rs = np.random.RandomState(7)
    q = rs.rand(B, H4, W4, K).astype(np.float32)
    h = rs.rand(B, 2 * H4, 2 * W4, K).astype(np.float32)
    tags = [(rs.rand(B, H4, W4, K) * 4).astype(np.float32) for _ in range(E)]
    return q, h, tags


def _nchw(a):
    return _t(a.transpose(0, 3, 1, 2))


def test_decode_batch_fused_matches_jax(model_outputs):
    """valid and joint x, y exact; scores and the rest within 5e-7 (the
    aggregate's ulp, see the module docstring)."""
    q, h, tags = model_outputs
    jj, js, jv = jax_decode_batch_fused(
        [jnp.asarray(q), jnp.asarray(h)], [jnp.asarray(t) for t in tags], input_hw=(H, W),
        max_num_people=8, det_thr=0.3, tag_thr=1.0, do_adjust=True, do_refine=True, interpret=True,
    )
    tj, ts, tv = decode_batch_fused([_nchw(q), _nchw(h)], [_nchw(t) for t in tags], (H, W),
                                    max_num_people=8, det_thr=0.3, tag_thr=1.0)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert int(tv.sum()) >= B * 2
    np.testing.assert_array_equal(tj[..., :2].numpy(), np.asarray(jj)[..., :2])
    np.testing.assert_allclose(tj[..., 2:].numpy(), np.asarray(jj)[..., 2:], rtol=0, atol=5e-7)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=0, atol=5e-7)


def _dyadic(a, bits=10):
    """Values on a 2**-bits grid: every bilinear formulation is then exact,
    so the dense and fused front ends see bit-identical maps."""
    return (np.round(a * 2 ** bits) / 2 ** bits).astype(np.float32)


def test_decode_batch_fused_agrees_with_dense():
    """The port's two front ends on the same model outputs (17 joints, 5
    persons, E=1) make the same decisions: same persons, joints and scores.
    The maps are dyadic, so F.interpolate's column-first resize and the phase
    lerps agree exactly and any difference would be the decode's."""
    n, q = 2, 16
    stages, tag_maps = [], []
    for i in range(n):
        kp, tgs = synth_scene(30 + i, h=q, w=2 * q, e=1, n_persons=5, sigma=1.0,
                              tag_values=[4.0 * p - 8.0 for p in range(5)])
        stages.append(kp)
        tag_maps.append(tgs[..., 0])
    quarter = _dyadic(np.stack(stages))  # [N, K, q, 2q]
    half = _dyadic(np.random.RandomState(5).rand(n, 17, 2 * q, 4 * q) * 0.01)
    tags = [_t(_dyadic(np.stack(tag_maps)))]
    args = ([_t(quarter), _t(half)], tags, (4 * q, 8 * q))
    fj, fs, fv = decode_batch_fused(*args, max_num_people=8, det_thr=0.05, tag_thr=0.5)
    dj, ds, dv = decode_batch(*args, max_num_people=8, det_thr=0.05, tag_thr=0.5)
    assert torch.equal(fv, dv) and int(fv.sum()) >= n * 4
    assert torch.equal(fj[..., :2], dj[..., :2])
    assert torch.allclose(fj, dj, rtol=0, atol=1e-6) and torch.allclose(fs, ds, rtol=0, atol=1e-6)


@pytest.mark.parametrize("case", ["three_stages", "unaligned", "half_stage_size", "tag_size", "rows"])
def test_decode_batch_fused_rejects_other_shapes(case):
    z = lambda *s: torch.zeros(s)  # noqa: E731
    stages, tags, hw, m = [z(1, 3, 8, 8), z(1, 3, 16, 16)], [z(1, 3, 8, 8)], (32, 32), 8
    if case == "three_stages":
        stages = stages + [z(1, 3, 32, 32)]
    elif case == "unaligned":
        hw = (30, 32)
    elif case == "half_stage_size":
        stages = [stages[0], z(1, 3, 16, 8)]
    elif case == "tag_size":
        tags = [z(1, 3, 16, 16)]
    else:
        m = 33
    with pytest.raises(ValueError):
        decode_batch_fused(stages, tags, hw, max_num_people=m)


def _production_candidates(seed, n_persons):
    """``test_grouping_production``'s candidates: a 17-joint 96x160 E=2 scene
    through JAX's top-k, in grouping order."""
    kpts, tags = synth_scene(seed, n_persons=n_persons)
    tags_k, coords_k, scores_k = jg.top_k(jnp.asarray(kpts), jnp.asarray(tags), 30)
    cand = np.concatenate([np.asarray(coords_k, np.float32), np.asarray(scores_k)[..., None],
                           np.asarray(tags_k)], axis=-1)
    return cand[list(ORDER)]


@pytest.mark.parametrize("case", ["production", "no_candidates"])
def test_match_per_image_matches_jax(case):
    """The per-image entry vs JAX's per-image Pallas kernel (interpret):
    equal joints and counts, and equal to the batched entry."""
    cand = np.stack([_production_candidates(13, 14), _production_candidates(21, 5)])
    if case == "no_candidates":
        cand[..., 2] = 0.01  # every score below det_thr
    jj, jc = match_by_tag_pallas(jnp.asarray(cand), det_thr=0.1, tag_thr=1.0, joints_order=ORDER,
                                 num_persons=30, interpret=True)
    joints, count = cuda_match.match_by_tag_per_image(_t(cand), 0.1, 1.0, ORDER, 30)
    np.testing.assert_array_equal(count.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(joints.numpy(), np.asarray(jj))
    bj, bc = cuda_match.match_by_tag_batched(_t(cand), 0.1, 1.0, ORDER, 30)
    assert torch.equal(bj, joints) and torch.equal(bc, count)
    assert (int(count.min()) >= 5) if case == "production" else int(count.max()) == 0


def test_match_per_image_lane_limit():
    """JAX's per-image kernel holds K*(3+E) in 128 lanes; so does the entry."""
    with pytest.raises(ValueError, match="128"):
        cuda_match.match_by_tag_per_image(torch.zeros(1, 17, 4, 3 + 6), 0.1, 1.0, tuple(range(17)), 4)
