"""The PyTorch port's decode (plain path, CPU) vs the JAX package.

Every kernel-bearing function is held against the JAX function it replaces,
run as the JAX package's own tests run it on the CPU (Pallas kernels in
interpret mode). The grouping and the refine argmax are the same algorithms
with the same tie rules in float32, so their outputs must be EQUAL; only
values that pass through a sum of a different association (person means,
bilinear resizes) get a tolerance, stated where it is used.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from human_pose_tpu.ops import decode_batch as jax_decode_batch
from human_pose_tpu.ops import grouping as jg
from human_pose_tpu.ops.heatmaps import average_stages as jax_average_stages
from human_pose_tpu.ops.hungarian import hungarian as jax_hungarian
from human_pose_tpu.ops.pallas_decode import refine_argmax_batch as jax_refine
from human_pose_tpu.ops.pallas_match import match_by_tag_pallas_batched
from human_pose_tpu_torch.ops import cuda_decode, cuda_match, decode_batch
from human_pose_tpu_torch.ops import average_stages
from human_pose_tpu_torch.ops import grouping as tg
from human_pose_tpu_torch.ops.hungarian import hungarian
from tests import oracle_decode as oracle
from tests.test_torch_port_cuda import TIE_PAIRS, refine_rounding_case
from tests.test_grouping_production import synth_scene
from tests.test_pallas_match import synth_candidates

ORDER = tuple(jg.JOINTS_ORDER)


def _cand(tags, coords, scores):
    return np.concatenate([coords.astype(np.float32), scores[..., None], tags], axis=-1)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("e", [1, 2])
def test_match_by_tag_matches_jax(seed, e):
    """Plain grouping == JAX's XLA scan == the Pallas batched kernel
    (interpret, unroll=4 as on the main path): equal joints and counts."""
    tags, coords, scores = synth_candidates(seed, k=17, m=12, e=e)
    ref_joints, ref_valid = jg.match_by_tag(
        jnp.asarray(tags), jnp.asarray(coords), jnp.asarray(scores), 0.1, 1.0
    )
    joints, valid = tg.match_by_tag(
        torch.from_numpy(tags), torch.from_numpy(coords), torch.from_numpy(scores), 0.1, 1.0
    )
    np.testing.assert_array_equal(valid.numpy(), np.asarray(ref_valid))
    np.testing.assert_array_equal(joints.numpy(), np.asarray(ref_joints))

    cand = _cand(tags, coords, scores)[list(ORDER)][None]
    pj, pc = match_by_tag_pallas_batched(
        jnp.asarray(cand), det_thr=0.1, tag_thr=1.0, joints_order=ORDER,
        num_persons=12, interpret=True, unroll=4,
    )
    assert int(pc[0]) == int(valid.sum())
    c = int(pc[0])
    np.testing.assert_array_equal(joints.numpy()[:c], np.asarray(pj)[0, :c])


def test_match_batched_mixed_sparsity_and_wide_person_cap():
    """One batch mixing an empty image, a single person and an all-rows-valid
    dense image, with more person slots (P=20) than candidates (M=12): the
    batched plain version equals the Pallas batched kernel slot for slot."""
    k, m, p = 17, 12, 20
    rng = np.random.RandomState(9)
    empty = (rng.randn(k, m, 1).astype(np.float32) * 0.05,
             rng.randint(0, 100, (k, m, 2)).astype(np.int32),
             np.sort(rng.rand(k, m).astype(np.float32) * 0.05, axis=1)[:, ::-1].copy())
    single = synth_candidates(7, k=k, m=m, e=1, n_persons=1)
    tags_d, coords_d, _ = synth_candidates(8, k=k, m=m, e=1, n_persons=4)
    scores_d = np.sort((0.2 + 0.8 * rng.rand(k, m)).astype(np.float32), axis=1)[:, ::-1].copy()
    cand = np.stack([
        _cand(*scene)[list(ORDER)] for scene in (empty, single, (tags_d, coords_d, scores_d))
    ])
    joints, count = cuda_match.match_by_tag_batched(torch.from_numpy(cand), 0.1, 1.0, ORDER, p)
    pj, pc = match_by_tag_pallas_batched(
        jnp.asarray(cand), det_thr=0.1, tag_thr=1.0, joints_order=ORDER,
        num_persons=p, interpret=True, unroll=4,
    )
    np.testing.assert_array_equal(count.numpy(), np.asarray(pc))
    assert count[0] == 0 and count[2] > m  # empty image; dense one overflows M
    for b in range(3):
        c = int(count[b])
        np.testing.assert_array_equal(joints[b, :c].numpy(), np.asarray(pj)[b, :c])
        assert not joints[b, c:].any()


def _refine_case(seed, b, k, hw, e, p):
    rng = np.random.RandomState(seed)
    return (rng.rand(b, k, hw).astype(np.float32), rng.randn(b, k, e, hw).astype(np.float32),
            rng.randn(b, p, e).astype(np.float32))


@pytest.mark.parametrize("e", [1, 2])
def test_refine_argmax_matches_jax(e):
    """Shapes of tests/test_pallas_decode.py, batched, with per-image counts:
    equal argmax on every consumed slot (p < counts), 0 on skipped slots."""
    hm, tags, prev = _refine_case(0, 2, 4, 4096, e, 6)
    counts = np.array([6, 3], np.int32)
    ref, _ = jax_refine(jnp.asarray(hm), jnp.asarray(tags), jnp.asarray(prev),
                        jnp.asarray(counts), interpret=True)
    got = cuda_decode.refine_argmax_batch(
        torch.from_numpy(hm), torch.from_numpy(tags), torch.from_numpy(prev),
        torch.from_numpy(counts),
    ).numpy()
    ref = np.asarray(ref)
    for bi, c in enumerate(counts):
        np.testing.assert_array_equal(got[bi, :, :c], ref[bi, :, :c])
        assert not got[bi, :, c:].any()


def test_refine_argmax_tie_first():
    """Constant heatmaps and zero tags: every position ties, position 0 wins."""
    hm = np.ones((1, 2, 256), np.float32)
    tags = np.zeros((1, 2, 1, 256), np.float32)
    prev = np.zeros((1, 3, 1), np.float32)
    counts = torch.tensor([3], dtype=torch.int32)
    ref, _ = jax_refine(jnp.asarray(hm), jnp.asarray(tags), jnp.asarray(prev), interpret=True)
    got = cuda_decode.refine_argmax_batch(
        torch.from_numpy(hm), torch.from_numpy(tags), torch.from_numpy(prev), counts
    )
    assert int(np.asarray(ref).max()) == 0 and int(got.max()) == 0


def _jax_refine_plain(hm, tags, prev):
    """The JAX package's formulation outside Pallas (``ops/grouping.py``
    ``refine_batch``'s ``per_person``) for any HW: [B, K, P] argmax."""
    hm, tags, prev = jnp.asarray(hm), jnp.asarray(tags), jnp.asarray(prev)
    d = tags[:, :, None] - prev[:, None, :, :, None]  # [B, K, P, E, HW]
    dist = jnp.abs(d[:, :, :, 0]) if tags.shape[2] == 1 else jnp.sqrt(jnp.sum(d ** 2, axis=3))
    return np.asarray(jnp.argmax(hm[:, :, None] - jnp.round(dist), axis=-1))


def _port_refine(hm, tags, prev, counts):
    return cuda_decode.refine_argmax_batch(
        torch.from_numpy(hm), torch.from_numpy(tags), torch.from_numpy(prev),
        torch.from_numpy(np.asarray(counts, np.int32))).numpy()


@pytest.mark.parametrize("first,second", TIE_PAIRS)
def test_refine_argmax_tie_lower_index_matches_jax(first, second):
    """Two equal maxima (the pairs the card tests place across a thread's
    pixel group, a warp, a block and a row split): the lower index wins in
    the port's plain version as in the Pallas kernel."""
    hm, tags, prev = _refine_case(first, 1, 2, 16384, 1, 3)
    tags[:], prev[:] = 0, 0
    hm[..., first] = hm[..., second] = 2.0
    ref, _ = jax_refine(jnp.asarray(hm), jnp.asarray(tags), jnp.asarray(prev), interpret=True)
    got = _port_refine(hm, tags, prev, [3])
    np.testing.assert_array_equal(got, np.asarray(ref))
    assert (got == first).all()


@pytest.mark.parametrize("e", [1, 2])
@pytest.mark.parametrize("hw", [1, 7, 4099, 96 * 160 + 3])
def test_refine_argmax_ragged_hw_matches_jax(hw, e):
    """Row lengths the Pallas kernel does not take (no multiple of 128):
    against the JAX package's XLA formulation."""
    hm, tags, prev = _refine_case(hw + e, 3, 2, hw, e, 9)
    counts = np.array([9, 4, 8], np.int32)
    ref = _jax_refine_plain(hm, tags, prev)
    got = _port_refine(hm, tags, prev, counts)
    for bi, c in enumerate(counts):
        np.testing.assert_array_equal(got[bi, :, :c], ref[bi, :, :c])
        assert not got[bi, :, c:].any()


@pytest.mark.parametrize("e", [1, 2])
def test_refine_argmax_person_counts_match_jax(e):
    """Counts 0, 1, 8, 9, 30, 32 in one batch at P = 32: equal to the Pallas
    kernel (interpret) on every consumed slot, 0 on the others."""
    hm, tags, prev = _refine_case(20 + e, 6, 3, 1024, e, 32)
    counts = np.array([0, 1, 8, 9, 30, 32], np.int32)
    ref, _ = jax_refine(jnp.asarray(hm), jnp.asarray(tags * 2), jnp.asarray(prev * 2),
                        jnp.asarray(counts), interpret=True)
    got = _port_refine(hm, tags * 2, prev * 2, counts)
    ref = np.asarray(ref)
    for bi, c in enumerate(counts):
        np.testing.assert_array_equal(got[bi, :, :c], ref[bi, :, :c])
        assert not got[bi, :, c:].any()


def test_refine_argmax_rounding_matches_jax():
    """Distances at halves of even and odd integers, one ulp beside them,
    at 2**23 - 0.5 and beyond: ``torch.round`` and ``jnp.round`` (the Pallas
    kernel, interpret) pick the same pixels, the ones a right rounding
    gives."""
    hm, tags, prev, counts, want = refine_rounding_case(1024)
    ref, _ = jax_refine(jnp.asarray(hm.numpy()), jnp.asarray(tags.numpy()),
                        jnp.asarray(prev.numpy()), interpret=True)
    got = cuda_decode.refine_argmax_batch(hm, tags, prev, counts)
    np.testing.assert_array_equal(np.asarray(ref), want.numpy())
    assert torch.equal(got, want)


@pytest.mark.parametrize("rows,hw,sms,want", [
    (24 * 17, 512 * 512, 132, 8),  # the main path: 3,264 blocks
    (1, 512 * 512, 132, 64),  # one row: as many blocks as keep 4096 pixels each
    (24 * 17, 64 * 64, 132, 1),  # small maps: one block a row
    (10 ** 6, 512 * 512, 132, 1),  # more rows than blocks wanted
    (2, 7, 132, 1),
])
def test_refine_splits(rows, hw, sms, want):
    assert cuda_decode.refine_splits(rows, hw, sms) == want


def test_refine_wrapper_rejects_bad_shapes():
    hm, tags, prev = _refine_case(1, 1, 2, 64, 1, 2)
    with pytest.raises(ValueError):
        cuda_decode.refine_argmax_batch(
            torch.from_numpy(hm), torch.from_numpy(tags[:, :1]), torch.from_numpy(prev),
            torch.tensor([2], dtype=torch.int32),
        )


@pytest.mark.parametrize("n", [5, 13, 30])
def test_hungarian_matches_jax(n):
    """Random costs with pad columns and fewer valid rows, and quantized
    grouping-like costs full of ties: the same assignment as JAX's solver."""
    rng = np.random.RandomState(n)
    for trial in range(3):
        rows, cols = rng.randint(1, n + 1), rng.randint(1, n + 1)
        if trial == 0:
            real = rng.rand(rows, cols).astype(np.float32) * 100
        else:
            real = (np.round(rng.rand(rows, cols) * 3) * 100 - rng.rand(rows, 1)).astype(np.float32)
        cost = np.full((n, n), np.float32(np.abs(real).max() * 2 + 100), np.float32)
        cost[:rows, :cols] = real
        want = np.asarray(jax_hungarian(jnp.asarray(cost), num_valid_rows=jnp.int32(rows)))
        got = hungarian(torch.from_numpy(cost), num_valid_rows=rows).numpy()
        np.testing.assert_array_equal(got, want)


def test_average_stages_matches_jax():
    """Quarter- and half-resolution stages, channel-major: the quarter stage
    is upsampled 2x and averaged with the half stage as in JAX. The two
    bilinear resizes sum their taps in different orders, so 1e-6 on values
    in [0, 1]."""
    rng = np.random.RandomState(4)
    quarter = rng.rand(2, 17, 12, 20).astype(np.float32)
    half = rng.rand(2, 17, 24, 40).astype(np.float32)
    want = np.asarray(jax_average_stages([jnp.asarray(quarter), jnp.asarray(half)],
                                         channel_major=True))
    got = average_stages([torch.from_numpy(quarter), torch.from_numpy(half)])
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


def _parse_both(kpts, tags, m, det_thr=0.1, tag_thr=1.0):
    jj, js, jv = jg.parse(jnp.asarray(kpts), jnp.asarray(tags), max_num_people=m,
                          det_thr=det_thr, tag_thr=tag_thr)
    tj, ts, tv = tg.parse_batch(
        torch.from_numpy(kpts)[None], torch.from_numpy(tags.transpose(0, 3, 1, 2).copy())[None],
        max_num_people=m, det_thr=det_thr, tag_thr=tag_thr,
    )
    return (np.asarray(jj), np.asarray(js), np.asarray(jv)), (tj[0].numpy(), ts[0].numpy(), tv[0].numpy())


@pytest.mark.parametrize("case", ["seed0", "seed1", "person_cap"])
def test_parse_batch_matches_jax_and_oracle(case):
    """17 joints, 96x160, E=2 (tests/test_grouping_production.py scenes):
    same persons and joints as JAX (the refine's person-mean tags are sums
    over K in another order, and person scores means over K: 1e-5), and the
    oracle's tie-invariant columns. ``person_cap`` puts 20 persons into 8
    slots."""
    if case == "person_cap":
        kpts, tags = synth_scene(7, n_persons=20, miss_p=0.3)
        m = 8
    else:
        kpts, tags = synth_scene(int(case[-1]))
        m = 30
    (jj, js, jv), (tj, ts, tv) = _parse_both(kpts, tags, m)
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_allclose(tj[tv], jj[jv], atol=1e-5)
    np.testing.assert_allclose(ts[tv], js[jv], atol=1e-5)
    oj, _ = oracle.parse_np(kpts, tags, max_num_people=m, det_thr=0.1, tag_thr=1.0)
    assert oj.shape == tj[tv].shape
    np.testing.assert_allclose(tj[tv][..., :3], oj[..., :3], atol=1e-3)
    if case == "person_cap":
        assert tv.sum() == m


def test_parse_batch_fallback_person():
    """No candidate above det_thr: one person of each joint's best candidate
    with score 0.01, as in JAX."""
    rng = np.random.RandomState(3)
    kpts = rng.rand(17, 32, 32).astype(np.float32) * 0.05
    tags = rng.randn(17, 32, 32, 1).astype(np.float32)
    (jj, js, jv), (tj, ts, tv) = _parse_both(kpts, tags, 10)
    assert tv.sum() == 1 and tv[0]
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_allclose(tj[tv], jj[jv], atol=1e-5)


def test_decode_batch_matches_jax():
    """Two-stage model outputs (1/4 and 1/2 of a 128x128 input, tags at 1/4)
    through the full decode, batch 2: the bilinear resizes associate their
    sums differently in the two frameworks (ulp-level), so the check is at
    the level of decisions: same persons, coordinates and scores within
    1e-3."""
    n, k, q = 2, 17, 32
    stages, tag_maps = [], []
    rng = np.random.RandomState(5)
    for i in range(n):
        kp, tgs = synth_scene(20 + i, h=q, w=q, e=1, n_persons=5, sigma=1.0,
                              tag_values=[4.0 * p - 8.0 for p in range(5)])
        stages.append(kp)
        tag_maps.append(tgs[..., 0])
    quarter = np.stack(stages).transpose(0, 2, 3, 1)  # [N, h, w, K]
    half = (rng.rand(n, 2 * q, 2 * q, k) * 0.01).astype(np.float32)
    tags_nhwk = np.stack(tag_maps).transpose(0, 2, 3, 1)

    jj, js, jv = jax_decode_batch(
        [jnp.asarray(quarter), jnp.asarray(half)], [jnp.asarray(tags_nhwk)],
        input_hw=(4 * q, 4 * q), max_num_people=30, det_thr=0.05, tag_thr=0.5,
    )
    nchw = lambda a: torch.from_numpy(a.transpose(0, 3, 1, 2).copy())  # noqa: E731
    tj, ts, tv = decode_batch([nchw(quarter), nchw(half)], [nchw(tags_nhwk)], (4 * q, 4 * q),
                              max_num_people=30, det_thr=0.05, tag_thr=0.5)
    jv, tv = np.asarray(jv), tv.numpy()
    np.testing.assert_array_equal(tv, jv)
    assert tv.sum() >= 2 * 4
    np.testing.assert_allclose(tj.numpy()[tv][..., :3], np.asarray(jj)[jv][..., :3], atol=1e-3)
    np.testing.assert_allclose(ts.numpy()[tv], np.asarray(js)[jv], atol=1e-3)
