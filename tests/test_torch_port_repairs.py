"""The port's entries that the JAX package has and the port lacked, the
person chunking of the refine kernels, and the float32 identities the phase
refine kernel's fast arithmetic rests on; each against the JAX package (or
torch's own rounding) on the CPU.

The refine functions run the plain versions here (CPU tensors). The person
chunking is the one piece of the card path that is host code: it is run with
the plain version as its launch, so the same code that splits persons for
the kernel is held against the unchunked result and against JAX.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from human_pose_tpu.ops import grouping as jg
from human_pose_tpu.ops.hungarian import hungarian_batch as jax_hungarian_batch
from human_pose_tpu.ops.pallas_aggregate import refine_argmax_phase_batch as jax_refine_phase
from human_pose_tpu.ops.pallas_decode import refine_argmax as jax_refine_argmax
from human_pose_tpu.ops.pallas_decode import refine_argmax_batch as jax_refine_batch
from human_pose_tpu_torch import ops
from human_pose_tpu_torch.ops import cuda_aggregate, cuda_decode
from tests.test_grouping_production import synth_scene

TWO23 = np.float32(2 ** 23)


def _refine_case(seed, b, k, hw, e, p):
    rng = np.random.RandomState(seed)
    return (rng.rand(b, k, hw).astype(np.float32), (rng.randn(b, k, e, hw) * 2).astype(np.float32),
            (rng.randn(b, p, e) * 2).astype(np.float32))


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("e", [1, 2])
def test_refine_argmax_batch_counts_none_matches_jax(e):
    """``counts=None`` refines every person, as in JAX: idx equal on every
    slot (the port returns idx alone; its caller gathers the value)."""
    hm, tags, prev = _refine_case(40 + e, 2, 3, 2048, e, 7)
    want, _ = jax_refine_batch(jnp.asarray(hm), jnp.asarray(tags), jnp.asarray(prev), interpret=True)
    got = ops.refine_argmax_batch(*_t(hm, tags, prev))
    assert got.dtype == torch.int32 and tuple(got.shape) == (2, 3, 7)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    explicit = ops.refine_argmax_batch(*_t(hm, tags, prev), torch.tensor([7, 7], dtype=torch.int32))
    assert torch.equal(got, explicit)


@pytest.mark.parametrize("e", [1, 2])
def test_refine_argmax_single_image_matches_jax(e):
    """One image, ``(idx, val)`` like the JAX function of that name."""
    hm, tags, prev = _refine_case(50 + e, 1, 4, 1024, e, 5)
    ji, jv = jax_refine_argmax(jnp.asarray(hm[0]), jnp.asarray(tags[0]), jnp.asarray(prev[0]),
                               interpret=True)
    idx, val = ops.refine_argmax(*_t(hm[0], tags[0], prev[0]))
    assert tuple(idx.shape) == (4, 5) and idx.dtype == torch.int32 and val.dtype == torch.float32
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(val.numpy(), np.asarray(jv))


def test_hungarian_batch_matches_jax():
    """Pad columns, fewer valid rows per problem, and tie-heavy costs."""
    rng = np.random.RandomState(3)
    n, batch = 9, 4
    costs = np.full((batch, n, n), 0, np.float32)
    rows = np.array([9, 5, 1, 7], np.int32)
    for i in range(batch):
        real = (np.round(rng.rand(n, 6) * 3) * 100 - rng.rand(n, 1)).astype(np.float32)
        costs[i] = np.float32(np.abs(real).max() * 2 + 100)
        costs[i, :, :6] = real
    want = np.asarray(jax_hungarian_batch(jnp.asarray(costs), jnp.asarray(rows)))
    got = ops.hungarian_batch(*_t(costs), num_valid_rows=torch.from_numpy(rows))
    np.testing.assert_array_equal(got.numpy(), want)
    want_all = np.asarray(jax_hungarian_batch(jnp.asarray(costs)))
    np.testing.assert_array_equal(ops.hungarian_batch(*_t(costs)).numpy(), want_all)


@pytest.mark.parametrize("seed", [0, 1])
def test_parse_single_image_matches_jax(seed):
    """17 joints, 96x160, E=2: the same decisions as JAX's ``parse`` (same
    persons and joint positions; scores and means within 1e-5, the sums of
    person means taken in another order)."""
    kpts, tags = synth_scene(seed)  # [K, H, W], [K, H, W, E]
    jj, js, jv = jg.parse(jnp.asarray(kpts), jnp.asarray(tags), max_num_people=30, det_thr=0.1,
                          tag_thr=1.0)
    tj, ts, tv = ops.parse(*_t(kpts, tags.transpose(0, 3, 1, 2)), max_num_people=30,
                           det_thr=0.1, tag_thr=1.0)
    jv = np.asarray(jv)
    np.testing.assert_array_equal(tv.numpy(), jv)
    assert tv.sum() >= 4
    np.testing.assert_array_equal(tj.numpy()[tv.numpy()][..., :2], np.asarray(jj)[jv][..., :2])
    np.testing.assert_allclose(tj.numpy()[tv.numpy()], np.asarray(jj)[jv], rtol=0, atol=1e-5)
    np.testing.assert_allclose(ts.numpy()[tv.numpy()], np.asarray(js)[jv], rtol=0, atol=1e-5)


def test_refine_single_image_matches_jax():
    """``refine`` of one image on grouped joints with undetected joints and a
    person without any detection: the same joints as JAX's ``refine``."""
    kpts, tags = synth_scene(4, e=1)
    k, h, w = kpts.shape
    rs = np.random.RandomState(6)
    p = 6
    g = np.zeros((p, k, 4), np.float32)
    g[..., 0] = rs.randint(0, w, (p, k))
    g[..., 1] = rs.randint(0, h, (p, k))
    g[..., 2] = np.where(rs.rand(p, k) < 0.4, 0.0, 0.1 + rs.rand(p, k)).astype(np.float32)
    g[3, :, 2] = 0.0  # no detection: left as it is
    g[..., 3] = rs.randn(p, k)
    want = np.asarray(jg.refine(jnp.asarray(kpts), jnp.asarray(tags), jnp.asarray(g)))
    got = ops.refine(*_t(kpts, tags.transpose(0, 3, 1, 2), g)).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got[..., 2] > g[..., 2]).any()
    np.testing.assert_array_equal(got[3], g[3])


def _dense_chunked(hm, tags, prev, counts):
    """The dense refine's card path with the plain version as the launch."""
    return cuda_decode.run_person_chunks(
        lambda pc, cc: cuda_decode.refine_argmax_batch_plain(hm, tags, pc, cc), prev, counts)


def _phase_chunked(avg, tags_lo, prev):
    return cuda_decode.run_person_chunks(
        lambda pc, _: cuda_aggregate.refine_argmax_phase_batch_plain(avg, tags_lo, pc), prev)


@pytest.mark.parametrize("p", [33, 40, 64, 127])
def test_person_chunks_equal_unchunked(p):
    """Persons in chunks of 32 (the kernels' limit), counts shifted and
    clamped per chunk: the same idx (dense refine, mixed counts) and idx and
    val (phase refine) as one unchunked plain call."""
    hm, tags, prev = _t(*_refine_case(p, 3, 2, 512, 2, p))
    counts = torch.tensor([p, 0, min(p, 35)], dtype=torch.int32)
    want = cuda_decode.refine_argmax_batch_plain(hm, tags, prev, counts)
    assert torch.equal(_dense_chunked(hm, tags, prev, counts), want)
    assert torch.equal(_dense_chunked(hm, tags, prev, None),
                       cuda_decode.refine_argmax_batch_plain(hm, tags, prev))

    rng = np.random.RandomState(p)
    avg, tags_lo, prev = _t(rng.rand(2, 2, 4, 4, 4, 8).astype(np.float32),
                            (rng.randn(2, 2, 1, 4, 8) * 2).astype(np.float32),
                            (rng.randn(2, p, 1) * 2).astype(np.float32))
    got = _phase_chunked(avg, tags_lo, prev)
    want = cuda_aggregate.refine_argmax_phase_batch_plain(avg, tags_lo, prev)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_person_chunks_match_jax_at_40():
    """P = 40 (two launches on the card) against the JAX kernels, which take
    any P: the dense refine with mixed counts (consumed slots) and the phase
    refine (idx and val)."""
    hm, tags, prev = _refine_case(7, 3, 2, 1024, 1, 40)
    counts = np.array([40, 33, 12], np.int32)
    want, _ = jax_refine_batch(jnp.asarray(hm), jnp.asarray(tags), jnp.asarray(prev),
                               jnp.asarray(counts), interpret=True)
    got = _dense_chunked(*_t(hm, tags, prev, counts)).numpy()
    for bi, c in enumerate(counts):
        np.testing.assert_array_equal(got[bi, :, :c], np.asarray(want)[bi, :, :c])
        assert not got[bi, :, c:].any()

    rng = np.random.RandomState(8)
    avg = rng.rand(2, 2, 4, 4, 4, 8).astype(np.float32)
    tags_lo = (rng.randn(2, 2, 2, 4, 8) * 2).astype(np.float32)
    prev = (rng.randn(2, 40, 2) * 2).astype(np.float32)
    ji, jv = jax_refine_phase(jnp.asarray(avg), jnp.asarray(tags_lo), jnp.asarray(prev),
                              interpret=True)
    idx, val = _phase_chunked(*_t(avg, tags_lo, prev))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(val.numpy(), np.asarray(jv))


def test_person_chunks_one_call_up_to_32():
    """Up to 32 persons the launch is called once, on the arguments as given
    (the main path's launch count stays one a call)."""
    calls = []
    prev, counts = torch.zeros((2, 32, 1)), torch.tensor([3, 32], dtype=torch.int32)
    out = cuda_decode.run_person_chunks(lambda pc, cc: calls.append((pc, cc)) or pc[..., 0], prev, counts)
    assert len(calls) == 1 and calls[0][0] is prev and calls[0][1] is counts
    assert tuple(out.shape) == (2, 32)
    calls.clear()
    cuda_decode.run_person_chunks(lambda pc, cc: calls.append((pc.shape[1], cc.tolist())) or pc[..., 0],
                                  torch.zeros((2, 70, 1)), torch.tensor([70, 40], dtype=torch.int32))
    assert calls == [(32, [32, 32]), (32, [32, 8]), (6, [6, 0])]


@pytest.mark.parametrize("maps,h4,w4,e,want", [
    (24 * 17, 128, 128, 1, 8),  # the fused path: 3,264 blocks of 64 full rows
    (24 * 17, 128, 128, 4, 8),
    (1, 128, 128, 1, 64),  # one map: as many blocks as keep 1024 groups each
    (6, 128, 128, 4, 64),
    (24 * 17, 16, 16, 1, 1),  # small maps: one block a map
    (2, 1, 3, 1, 1),
    (10 ** 4, 8, 10000, 1, 5),  # wide rows: split until the staged rows fit
])
def test_phase_refine_splits(maps, h4, w4, e, want):
    splits = cuda_aggregate.phase_refine_splits(maps, h4, w4, e, 132)
    assert splits == want
    assert cuda_aggregate.staged_bytes(h4, w4, e, splits) <= cuda_aggregate.MAX_SMEM


def test_phase_refine_staged_bytes():
    """A block stages the quarter rows of its full rows plus a halo row a
    side; one block a map stages the whole plane, which at E=4 and 128x128
    is over the limit (the parent kernel's refusal), 8 blocks are not."""
    assert cuda_aggregate.staged_bytes(128, 128, 1, 8) == 4 * 128 * 20
    assert cuda_aggregate.staged_bytes(128, 128, 4, 1) == 4 * 4 * 128 * 128 > cuda_aggregate.MAX_SMEM
    assert cuda_aggregate.staged_bytes(128, 128, 4, 8) <= cuda_aggregate.MAX_SMEM


def _magic_round(x: torch.Tensor) -> torch.Tensor:
    two23 = torch.tensor(TWO23)
    return (x + two23) - two23


def test_round_by_two_adds_equals_round():
    """``(x + 2**23) - 2**23`` rounds float32 x in [0, 2**23) halves to even,
    exactly as ``torch.round``: every k + 0.5 up to 2**12, the floats one ulp
    beside each, and 10**6 seeded values (uniform and log-uniform)."""
    halves = np.arange(4096, dtype=np.float32) + np.float32(0.5)
    below = np.nextafter(halves, np.float32(0))
    above = np.nextafter(halves, np.float32(np.inf))
    rng = np.random.default_rng(0)
    uniform = (rng.random(500_000) * float(TWO23)).astype(np.float32)
    log_uniform = np.exp2(rng.uniform(-30.0, 23.0, 500_000)).astype(np.float32)
    edges = np.array([0.0, 0.49999997, 0.5, 1.5, 2.5, 8388607.0, 8388607.5,
                      np.nextafter(TWO23, np.float32(0))], np.float32)
    x = torch.from_numpy(np.concatenate([halves, below, above, uniform, log_uniform, edges]))
    x = x[x < float(TWO23)]
    assert x.dtype == torch.float32 and x.numel() > 10 ** 6
    assert torch.equal(_magic_round(x), torch.round(x))


def test_abs_distance_equals_sqrt_of_square():
    """At E=1 the kernel's fast instance takes ``|d|`` for ``sqrt(d*d)``: equal
    after ``torch.round`` for float32 |d| < 2**20 (seeded values, every
    binade down to the subnormals), and different at |d| = 2**64, where
    ``d*d`` overflows to infinity: the reason for the rintf instance."""
    rng = np.random.default_rng(1)
    mags = np.exp2(rng.uniform(-149.0, 20.0, 1_000_000)).astype(np.float32)
    subnormal = (rng.integers(1, 2 ** 23, 100_000) * np.float32(2.0 ** -149)).astype(np.float32)
    halves = np.arange(1, 2 ** 12, dtype=np.float32) - np.float32(0.5)
    d = np.concatenate([mags, subnormal, halves, np.nextafter(halves, np.float32(np.inf))])
    d = d[np.abs(d) < 2 ** 20]
    d = torch.from_numpy(np.concatenate([d, -d]))
    assert torch.equal(torch.round(d.abs()), torch.round(torch.sqrt(d * d)))
    assert torch.equal(_magic_round(d.abs()), torch.round(torch.sqrt(d * d)))
    big = torch.tensor([2.0 ** 64, -(2.0 ** 64)], dtype=torch.float32)
    assert torch.isinf(torch.round(torch.sqrt(big * big))).all()
    assert torch.isfinite(torch.round(big.abs())).all()
