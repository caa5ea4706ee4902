"""The port's CUDA kernels vs their plain versions, on the card.

Marked ``cuda``: each test skips where no card is present (decided in the
fixture, never at import). The file imports neither JAX nor the JAX package,
so it runs on a machine without them:

    python -m pytest -o addopts="" --noconftest -m cuda tests/test_torch_port_cuda.py

The decode kernels repeat their plain versions' float32 arithmetic step for
step, so those comparisons are exact. The fused BasicBlock sums its
convolutions in another order than cuDNN: float32 (3xTF32 on the tensor
cores) within 1e-4 (TF32 off in cuDNN), bfloat16 (bf16 operands on the
tensor cores) within 2**-6 of the output's scale, a few bf16 ulps: an
intermediate value at a bf16 rounding boundary can round either way.
"""

from __future__ import annotations

import copy
import json

import numpy as np
import pytest
import torch

from human_pose_tpu_torch.ops import (
    JOINTS_ORDER, decode_batch, decode_batch_fused, fused_aggregate, fused_aggregate_plain,
    fused_basic_block, fused_basic_block_plain, match_by_tag_batched, match_by_tag_batched_plain,
    match_by_tag_per_image, refine_argmax_batch, refine_argmax_batch_plain,
    refine_argmax_phase_batch, refine_argmax_phase_batch_plain,
)
from human_pose_tpu_torch.ops import cuda_aggregate
from human_pose_tpu_torch.ops.phase import phase_to_dense

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _candidates(seed, b, k, m, e, n_persons):
    """Candidate rows like top_k gives them: scores descending, the top rows
    real detections clustered by person tag."""
    rng = np.random.RandomState(seed)
    tags = rng.randn(b, k, m, e).astype(np.float32) * 0.05
    scores = np.sort(rng.rand(b, k, m).astype(np.float32) * 0.04, axis=2)[..., ::-1].copy()
    for p in range(n_persons):
        tag_val = rng.randn(b, 1, e).astype(np.float32) * 4
        scores[:, :, p] = 0.5 + 0.5 * rng.rand(b, k)
        tags[:, :, p] = tag_val + rng.randn(b, k, e) * 0.02
    coords = rng.randint(0, 512, (b, k, m, 2)).astype(np.float32)
    cand = np.concatenate([coords, scores[..., None], tags], axis=-1)
    return torch.from_numpy(cand[:, list(JOINTS_ORDER)].copy())


@pytest.mark.parametrize("e", [1, 2])
@pytest.mark.parametrize("m,p,n_persons", [(30, 30, 12), (30, 30, 40), (12, 20, 16)])
def test_match_kernel_equals_plain(dev, e, m, p, n_persons):
    cand = _candidates(e * 100 + m + n_persons, 8, 17, m, e, min(n_persons, m))
    want_j, want_c = match_by_tag_batched_plain(cand, 0.1, 1.0, JOINTS_ORDER, p)
    before = match_by_tag_batched.launches
    got_j, got_c = match_by_tag_batched(cand.to(dev), 0.1, 1.0, JOINTS_ORDER, p)
    torch.cuda.synchronize()
    assert match_by_tag_batched.launches == before + 1
    assert torch.equal(got_c.cpu(), want_c)
    assert torch.equal(got_j.cpu(), want_j)


def _refine_inputs(seed, b, k, hw, e, p, big_every=0):
    """Random refine inputs; with ``big_every`` every such pixel's tags are
    scaled by 1e6, past the range where the kernel rounds by adding 2**23."""
    rng = np.random.RandomState(seed)
    hm = rng.rand(b, k, hw).astype(np.float32)
    tags = rng.randn(b, k, e, hw).astype(np.float32) * 2
    if big_every:
        tags[..., ::big_every] *= np.float32(1e6)
    prev = rng.randn(b, p, e).astype(np.float32) * 2
    return torch.from_numpy(hm), torch.from_numpy(tags), torch.from_numpy(prev)


def refine_rounding_case(hw=1024):
    """Refine inputs (E=1, one person with tag 0, so the distance of a pixel
    is its |tag|) that tell a wrong rounding of the distance from a right
    one: halves at even and odd integers, one ulp below and above each,
    2**23 - 0.5, 2**23 and beyond. Two rows per distance x, all pixels at
    -1e30 but two: pixel a has tag x and heatmap rint(x) (difference 0 when
    x is rounded right), pixel c has tag 0 and heatmap -0.25 in the first
    row (c wins if x was rounded up too far) and +0.25 in the second (a wins
    if x was rounded down too far). Returns (hm, tags, prev, counts, want)."""
    halves = np.array([0.5, 1.5, 2.5, 3.5, 100.5, 101.5, 4194302.5, 4194303.5], np.float32)
    xs = np.concatenate([
        halves, np.nextafter(halves, np.float32(0)), np.nextafter(halves, np.float32(np.inf)),
        np.array([8388607.5, 8388608.0, 8388609.0, 16777218.0, 1e10, 0.49999997, 1048575.5,
                  1048576.5, 2097151.5], np.float32),
    ]).astype(np.float32)
    k = 2 * len(xs)
    hm = np.full((1, k, hw), -1e30, np.float32)
    tags = np.zeros((1, k, 1, hw), np.float32)
    want = np.zeros((1, k, 1), np.int32)
    for j, x in enumerate(xs):
        for row, (other, winner) in enumerate(((-0.25, "a"), (0.25, "c"))):
            r = 2 * j + row
            a, c = (5 + 7 * j) % hw, (hw - 3 - 5 * j) % hw
            if row:
                a, c = c, a
            tags[0, r, 0, a] = x
            hm[0, r, a] = np.rint(x)
            hm[0, r, c] = other
            want[0, r, 0] = a if winner == "a" else c
    return (torch.from_numpy(hm), torch.from_numpy(tags), torch.zeros((1, 1, 1)),
            torch.tensor([1], dtype=torch.int32), torch.from_numpy(want))


def _refine_on_card(dev, hm, tags, prev, counts, splits=None):
    before = refine_argmax_batch.launches
    got = refine_argmax_batch(hm.to(dev), tags.to(dev), prev.to(dev), counts.to(dev), splits=splits)
    torch.cuda.synchronize()
    assert refine_argmax_batch.launches == before + 1  # one call, one counted launch
    return got.cpu()


@pytest.mark.parametrize("e", [1, 2, 3, 4])
def test_refine_kernel_equals_plain(dev, e):
    """Random maps, some tags past the fast rounding's range, mixed counts."""
    hm, tags, prev = _refine_inputs(e, 4, 5, 96 * 160, e, 30, big_every=97)
    counts = torch.tensor([30, 0, 1, 17], dtype=torch.int32)
    want = refine_argmax_batch_plain(hm, tags, prev, counts)
    assert torch.equal(_refine_on_card(dev, hm, tags, prev, counts), want)


@pytest.mark.parametrize("splits", [None, 1, 3])
@pytest.mark.parametrize("hw", [96 * 160 + 3, 4099, 7, 1])
@pytest.mark.parametrize("e", [1, 2])
def test_refine_kernel_ragged_hw(dev, e, hw, splits):
    """HW that is no multiple of 4 nor of a block's 1024-pixel stride; with
    an odd HW every row after the first starts off a 16-byte boundary."""
    hm, tags, prev = _refine_inputs(hw + e, 3, 2, hw, e, 9)
    counts = torch.tensor([9, 4, 8], dtype=torch.int32)
    want = refine_argmax_batch_plain(hm, tags, prev, counts)
    assert torch.equal(_refine_on_card(dev, hm, tags, prev, counts, splits), want)


def test_refine_kernel_unaligned_base(dev):
    """Maps that are contiguous views starting 4 bytes into their storage."""
    hm, tags, prev = _refine_inputs(11, 2, 3, 4096, 1, 6)
    counts = torch.tensor([6, 3], dtype=torch.int32)
    want = refine_argmax_batch_plain(hm, tags, prev, counts)
    hm_d = torch.empty(hm.numel() + 1, device=dev)[1:].view(hm.shape).copy_(hm)
    tags_d = torch.empty(tags.numel() + 1, device=dev)[1:].view(tags.shape).copy_(tags)
    assert hm_d.data_ptr() % 16 == 4 and hm_d.is_contiguous()
    got = refine_argmax_batch(hm_d, tags_d, prev.to(dev), counts.to(dev))
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("e", [1, 2])
def test_refine_kernel_person_counts(dev, e):
    """Every compiled person count (8, 16, 24, 32) and its edges in one
    batch at P = 32; slots at and past counts[b] are 0."""
    hm, tags, prev = _refine_inputs(20 + e, 6, 3, 8192, e, 32)
    counts = torch.tensor([0, 1, 8, 9, 30, 32], dtype=torch.int32)
    want = refine_argmax_batch_plain(hm, tags, prev, counts)
    got = _refine_on_card(dev, hm, tags, prev, counts)
    assert torch.equal(got, want)
    for b, c in enumerate(counts.tolist()):
        assert not got[b, :, c:].any()


@pytest.mark.parametrize("splits", [None, 1, 2, 5])
def test_refine_kernel_tie_first(dev, splits):
    """A constant map: every pixel ties, in every thread, warp, block and
    split; pixel 0 must win."""
    hm = torch.ones((2, 3, 16384))
    tags = torch.zeros((2, 3, 1, 16384))
    prev = torch.zeros((2, 8, 1))
    counts = torch.tensor([8, 2], dtype=torch.int32)
    assert int(_refine_on_card(dev, hm, tags, prev, counts, splits).abs().max()) == 0


# two equal maxima whose pixels lie in: one thread's 4-pixel group, two
# neighbouring groups, two warps, two steps of a block, two splits (of 4
# over 16384 pixels), and the row's two ends
TIE_PAIRS = [(1, 2), (3, 4), (127, 128), (1023, 1024), (4095, 4096), (5, 16383)]


@pytest.mark.parametrize("first,second", TIE_PAIRS)
def test_refine_kernel_tie_lower_index_wins(dev, first, second):
    hm, tags, prev = _refine_inputs(first, 1, 2, 16384, 1, 3)
    tags.zero_(), prev.zero_()  # the difference is the heatmap itself
    hm[..., first] = 2.0
    hm[..., second] = 2.0
    counts = torch.tensor([3], dtype=torch.int32)
    want = refine_argmax_batch_plain(hm, tags, prev, counts)
    assert int(want.min()) == first and int(want.max()) == first
    for splits in (1, 4):
        assert torch.equal(_refine_on_card(dev, hm, tags, prev, counts, splits), want)


@pytest.mark.parametrize("hw", [1024, 1027])
def test_refine_kernel_rounding(dev, hw):
    """Distances at halves, beside them and past 2**23 round as torch.round
    does (halves to even)."""
    hm, tags, prev, counts, want = refine_rounding_case(hw)
    assert torch.equal(refine_argmax_batch_plain(hm, tags, prev, counts), want)
    assert torch.equal(_refine_on_card(dev, hm, tags, prev, counts), want)


def test_refine_kernel_negative_zero_ties(dev):
    """-0.0 and +0.0 differences are equal: the lower index wins whichever
    sign it carries."""
    hm = torch.full((1, 2, 4096), -1.0)
    hm[0, 0, 7], hm[0, 0, 2000] = -0.0, 0.0
    hm[0, 1, 7], hm[0, 1, 2000] = 0.0, -0.0
    tags = torch.zeros((1, 2, 1, 4096))
    prev = torch.zeros((1, 1, 1))
    counts = torch.tensor([1], dtype=torch.int32)
    want = refine_argmax_batch_plain(hm, tags, prev, counts)
    assert want.flatten().tolist() == [7, 7]
    assert torch.equal(_refine_on_card(dev, hm, tags, prev, counts, 2), want)


def test_decode_card_equals_cpu(dev):
    """Full decode on the card vs the CPU path (plain kernels) on the same
    full-resolution maps (resizes are identities, so inputs are bit-equal)."""
    rng = np.random.RandomState(0)
    n, k, h, w = 2, 17, 128, 128
    hm = rng.rand(n, k, h, w).astype(np.float32) * 0.02
    tg = rng.randn(n, k, h, w).astype(np.float32) * 0.05
    for i in range(n):
        for person in range(8):
            for j in range(k):
                y, x = rng.randint(2, h - 2), rng.randint(2, w - 2)
                hm[i, j, y, x] = 0.5 + 0.5 * rng.rand()
                tg[i, j, y - 2:y + 3, x - 2:x + 3] = 3.0 * person + rng.randn(5, 5) * 0.01
    stages = [torch.from_numpy(hm)]
    tags = [torch.from_numpy(tg)]
    cj, cs, cv = decode_batch(stages, tags, (h, w), det_thr=0.05, tag_thr=0.5)
    gj, gs, gv = decode_batch([s.to(dev) for s in stages], [t.to(dev) for t in tags], (h, w),
                              det_thr=0.05, tag_thr=0.5)
    assert torch.equal(gv.cpu(), cv) and int(cv.sum()) >= 2 * 8
    assert torch.allclose(gj.cpu()[cv], cj[cv], atol=1e-5, rtol=0)


def _aggregate_on_card(dev, q, h2, rows=None):
    """The kernel on the card vs the plain version (on the card, same
    inputs): avg, sup and cmax equal, one launch a call."""
    q, h2 = q.to(dev), h2.to(dev)
    want = fused_aggregate_plain(q, h2)
    before = fused_aggregate.launches
    got = fused_aggregate(q, h2, rows)
    torch.cuda.synchronize()
    assert fused_aggregate.launches == before + 1
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    return [g.cpu() for g in got]


def _aggregate_inputs(seed, b, k, h4, w4):
    """Signed maps with a flat 5.0 plateau, above every other value (the NMS
    keeps every equal maximum)."""
    rng = np.random.RandomState(seed)
    q = rng.randn(b, k, h4, w4).astype(np.float32)
    h2 = rng.randn(b, k, 2 * h4, 2 * w4).astype(np.float32)
    q[0, 0, : max(1, h4 // 2), : max(1, w4 // 2)] = 5.0
    h2[0, 0, :h4, :w4] = 5.0
    return torch.from_numpy(q), torch.from_numpy(h2)


@pytest.mark.parametrize("b,k,h4,w4", [(2, 3, 16, 128), (3, 5, 13, 20), (1, 2, 1, 3), (1, 1, 1, 1),
                                       (1, 1, 5, 1), (1, 2, 37, 9), (1, 1, 8, 1024)])
def test_fused_aggregate_kernel_equals_plain(dev, b, k, h4, w4):
    """Bit-equal maps and row maxima on tiny, ragged and wide maps (W4 = 1024
    runs as column tiles inside a block)."""
    _aggregate_on_card(dev, *_aggregate_inputs(h4, b, k, h4, w4))


@pytest.mark.parametrize("h4,w4", [(11, 45), (6, 70)])
def test_fused_aggregate_kernel_every_rows(dev, h4, w4):
    """Every strip height R = 1 .. H4 gives the same outputs."""
    q, h2 = _aggregate_inputs(h4 + w4, 2, 2, h4, w4)
    for rows in range(1, h4 + 1):
        _aggregate_on_card(dev, q, h2, rows)
    with pytest.raises(ValueError):
        fused_aggregate(q.to(dev), h2.to(dev), h4 + 1)


def _boundary_maps():
    """16x64 maps (two warps of quarter columns) whose maxima sit on full row
    16 (a strip boundary for rows 1, 2, 4) and column 128 (the second warp's
    first column): a 5.0 plateau on rows 15-16, columns 127-128; two equal
    peaks diagonal across that corner; one peak exactly at (16, 128)."""
    rng = np.random.RandomState(16)
    q = (rng.rand(1, 3, 16, 64) * 0.5).astype(np.float32)
    h2 = (rng.rand(1, 3, 32, 128) * 0.5).astype(np.float32)
    q[0, 0, 3:5, 31:33] = 5.0
    h2[0, 0, 6:10, 62:66] = 5.0
    q[0, 1:] = 0.0
    h2[0, 1:] = 0.0
    h2[0, 1, 7, 63] = h2[0, 1, 8, 64] = 8.0
    h2[0, 2, 7, 63] = h2[0, 2, 7, 64] = h2[0, 2, 8, 63] = 4.0
    h2[0, 2, 8, 64] = 8.0
    return torch.from_numpy(q), torch.from_numpy(h2)


@pytest.mark.parametrize("rows", [None, 1, 2, 4, 16])
def test_fused_aggregate_kernel_boundary_maxima(dev, rows):
    """A plateau and peaks placed across a strip boundary and a warp
    boundary: every equal maximum is kept, as in the plain version."""
    _, sup, _ = _aggregate_on_card(dev, *_boundary_maps(), rows)
    tops = [sorted({(int(y), int(x)) for y, x in (m == m.max()).nonzero().tolist()})
            for m in phase_to_dense(sup)[0]]
    assert tops == [[(15, 127), (15, 128), (16, 127), (16, 128)], [(15, 127), (16, 128)], [(16, 128)]]


def _phase_inputs(seed, b, k, h4, w4, e, p, scale=2.0):
    rng = np.random.RandomState(seed)
    avg = rng.rand(b, k, 4, 4, h4, w4).astype(np.float32)
    tags = (rng.randn(b, k, e, h4, w4) * scale).astype(np.float32)
    prev = (rng.randn(b, p, e) * scale).astype(np.float32)
    return torch.from_numpy(avg), torch.from_numpy(tags), torch.from_numpy(prev)


def _phase_on_card(dev, avg, tags, prev, splits=None, launches=1):
    """The kernel on the card vs the plain version (on the card, same
    inputs): idx and val exact; ``launches`` counted launches a call."""
    avg, tags, prev = avg.to(dev), tags.to(dev), prev.to(dev)
    want = refine_argmax_phase_batch_plain(avg, tags, prev)
    before = refine_argmax_phase_batch.launches
    got = refine_argmax_phase_batch(avg, tags, prev, splits=splits)
    torch.cuda.synchronize()
    assert refine_argmax_phase_batch.launches == before + launches
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    return got[0].cpu(), got[1].cpu()


@pytest.mark.parametrize("splits", [None, 1, 5])
@pytest.mark.parametrize("e", [1, 2, 3, 4])
def test_refine_phase_kernel_equals_plain(dev, e, splits):
    _phase_on_card(dev, *_phase_inputs(e, 2, 3, 24, 40, e, 30), splits=splits)


@pytest.mark.parametrize("p", [1, 2, 29, 30, 31, 32, 40, 64])
@pytest.mark.parametrize("e", [1, 2])
def test_refine_phase_kernel_person_counts(dev, e, p):
    """Every compiled person count's neighbourhood; 40 and 64 persons run as
    two launches of at most 32 (the wrapper's person chunks)."""
    _phase_on_card(dev, *_phase_inputs(p + e, 2, 2, 16, 24, e, p), launches=-(-p // 32))


@pytest.mark.parametrize("splits", [None, 1, 3, 7])
@pytest.mark.parametrize("h4,w4", [(13, 37), (1, 3), (5, 1), (9, 300)])
def test_refine_phase_kernel_ragged(dev, h4, w4, splits):
    """Odd widths and heights, one-row and one-column maps, rows wider than
    a block's 256 threads, splits that leave the last block short or empty."""
    _phase_on_card(dev, *_phase_inputs(h4 * w4, 2, 2, h4, w4, 1, 7), splits=splits)


def test_refine_phase_kernel_tie_first(dev):
    avg = torch.ones((2, 3, 4, 4, 16, 16), device=dev)
    tags = torch.zeros((2, 3, 1, 16, 16), device=dev)
    prev = torch.zeros((2, 8, 1), device=dev)
    for splits in (None, 1, 4):
        idx, val = refine_argmax_phase_batch(avg, tags, prev, splits=splits)
        assert int(idx.abs().max()) == 0 and bool((val == 1).all())


# full-resolution (y, x) pairs of two equal maxima: two pixels of one
# 4-pixel group, neighbouring groups, two rows of one quarter row, two
# splits (of 4 over 64 rows), the map's two ends
PHASE_TIE_PAIRS = [((5, 1), (5, 2)), ((5, 3), (5, 4)), ((0, 9), (1, 0)), ((15, 40), (16, 3)),
                   ((2, 6), (63, 63))]


@pytest.mark.parametrize("first,second", PHASE_TIE_PAIRS)
def test_refine_phase_kernel_tie_lower_index_wins(dev, first, second):
    avg, tags, prev = _phase_inputs(first[1], 1, 2, 16, 16, 1, 3)
    tags.zero_(), prev.zero_()  # the difference is the heatmap itself
    for y, x in (first, second):
        avg[:, :, y % 4, x % 4, y // 4, x // 4] = 2.0
    for splits in (1, 4):
        idx, val = _phase_on_card(dev, avg, tags, prev, splits=splits)
        assert bool((idx == first[0] * 64 + first[1]).all()) and bool((val == 2.0).all())


def test_refine_phase_kernel_big_tags(dev):
    """Groups whose upsampled tags reach 2**20 take the rintf instance; at
    E=1 a distance of 2**64 or more is infinite in JAX's sqrt(d*d) form
    (difference -inf), where |d| would be finite; person tags past 2**20
    send a whole block there."""
    avg, tags, prev = _phase_inputs(3, 2, 3, 16, 24, 1, 30)
    tags[0, 0, 0, 3:6, 4:9] = 3e6  # some groups around (3..5, 4..8) past 2**20
    tags[0, 1, 0, :, :] = 2e19  # every |d| >= 2**64: all -inf, the first pixel wins
    tags[1, 2, 0, ::3, ::2] *= np.float32(1e6)
    idx, val = _phase_on_card(dev, avg, tags, prev)
    assert int(idx[0, 1].max()) == 0
    _phase_on_card(dev, avg, tags, prev * 1e6, splits=3)
    avg2, tags2, prev2 = _phase_inputs(4, 2, 2, 16, 24, 2, 12)
    tags2[..., ::5, ::3] *= np.float32(1e7)
    _phase_on_card(dev, avg2, tags2, prev2)


@pytest.mark.parametrize("e,h4,w4", [(3, 128, 160), (4, 128, 128)])
def test_refine_phase_kernel_large_planes(dev, e, h4, w4):
    """E*H4*W4*4 past 200 KB (the parent kernel staged whole planes in
    shared memory and refused these); one block a map is still refused."""
    avg, tags, prev = _phase_inputs(e, 1, 2, h4, w4, e, 30)
    assert e * h4 * w4 * 4 > 200 * 1024
    _phase_on_card(dev, avg, tags, prev)
    with pytest.raises(ValueError):
        refine_argmax_phase_batch(avg.to(dev), tags.to(dev), prev.to(dev), splits=1)


@pytest.mark.parametrize("h4,w4", [(1, 5), (5, 7), (7, 33)])
def test_refine_phase_kernel_every_split(dev, h4, w4, monkeypatch):
    """Every row split of a map: the shared memory the wrapper sizes
    (``staged_bytes``) holds each block's staged tag rows as the kernel
    counts them, and a byte count short of that is refused by the launch."""
    avg, tags, prev = _phase_inputs(h4 + w4, 1, 2, h4, w4, 2, 5)
    for splits in range(1, 4 * h4 + 1):
        _phase_on_card(dev, avg, tags, prev, splits=splits)
    sized = cuda_aggregate.staged_bytes
    monkeypatch.setattr(cuda_aggregate, "staged_bytes", lambda *a: sized(*a) - 4)
    with pytest.raises(RuntimeError):  # one block stages all h4 rows: 4 bytes short
        refine_argmax_phase_batch(avg.to(dev), tags.to(dev), prev.to(dev), splits=1)


@pytest.mark.parametrize("e", [1, 2])
def test_refine_kernel_person_chunks(dev, e):
    """The dense refine at P = 40 with mixed counts: two launches of at most
    32 persons, counts shifted and clamped per chunk."""
    hm, tags, prev = _refine_inputs(40 + e, 4, 3, 4096, e, 40)
    counts = torch.tensor([40, 0, 33, 17], dtype=torch.int32)
    want = refine_argmax_batch_plain(hm, tags, prev, counts)
    before = refine_argmax_batch.launches
    got = refine_argmax_batch(hm.to(dev), tags.to(dev), prev.to(dev), counts.to(dev))
    torch.cuda.synchronize()
    assert refine_argmax_batch.launches == before + 2
    assert torch.equal(got.cpu(), want)
    assert torch.equal(refine_argmax_batch(hm.to(dev), tags.to(dev), prev.to(dev)).cpu(),
                       refine_argmax_batch_plain(hm, tags, prev))


@pytest.mark.parametrize("e", [1, 2])
@pytest.mark.parametrize("p", [30, 50, 64, 127])
def test_match_kernel_columns_per_lane(dev, e, p):
    """1 to 4 assignment columns per lane (P = 30, 50, 64, 127: max(M, P) + 1
    columns over 32 lanes), with more persons than one joint's candidates so
    that the person count grows past a warp."""
    cand = _candidates(p + e, 4, 17, 30, e, 30)
    rng = np.random.RandomState(p)
    cand[..., 3:] += torch.from_numpy(rng.randn(4, 17, 1, e).astype(np.float32) * 6)  # new persons per joint
    want_j, want_c = match_by_tag_batched_plain(cand, 0.1, 1.0, JOINTS_ORDER, p)
    got_j, got_c = match_by_tag_batched(cand.to(dev), 0.1, 1.0, JOINTS_ORDER, p)
    torch.cuda.synchronize()
    assert int(want_c.max()) == p
    assert torch.equal(got_c.cpu(), want_c)
    assert torch.equal(got_j.cpu(), want_j)


@pytest.mark.parametrize("e", [1, 2])
def test_match_kernel_ties(dev, e):
    """Equal scores and dyadic tags on a coarse grid: many costs tie, so the
    argmin's lowest-column rule decides most assignments."""
    rng = np.random.RandomState(e)
    b, k, m = 4, 17, 30
    tags = rng.randint(0, 6, (b, k, m, e)).astype(np.float32) * 0.5
    scores = np.full((b, k, m), 0.5, np.float32)
    scores[:, :, m - 4:] = 0.0  # a few invalid rows
    coords = rng.randint(0, 64, (b, k, m, 2)).astype(np.float32)
    cand = torch.from_numpy(np.concatenate([coords, scores[..., None], tags], axis=-1)[:, list(JOINTS_ORDER)]
                            .copy())
    for p in (30, 40):
        want_j, want_c = match_by_tag_batched_plain(cand, 0.1, 1.0, JOINTS_ORDER, p)
        got_j, got_c = match_by_tag_batched(cand.to(dev), 0.1, 1.0, JOINTS_ORDER, p)
        torch.cuda.synchronize()
        assert torch.equal(got_c.cpu(), want_c)
        assert torch.equal(got_j.cpu(), want_j)


def test_match_per_image_kernel_equals_plain_and_batched(dev):
    cand = _candidates(7, 6, 17, 30, 2, 20)
    want_j, want_c = match_by_tag_batched_plain(cand, 0.1, 1.0, JOINTS_ORDER, 30)
    before = match_by_tag_per_image.launches
    got_j, got_c = match_by_tag_per_image(cand.to(dev), 0.1, 1.0, JOINTS_ORDER, 30)
    torch.cuda.synchronize()
    assert match_by_tag_per_image.launches == before + 1
    assert torch.equal(got_c.cpu(), want_c) and torch.equal(got_j.cpu(), want_j)
    bat_j, bat_c = match_by_tag_batched(cand.to(dev), 0.1, 1.0, JOINTS_ORDER, 30)
    assert torch.equal(bat_j, got_j) and torch.equal(bat_c, got_c)


def _block_inputs(shape, dev, dtype):
    rng = np.random.RandomState(shape[-1])
    c = shape[-1]
    x = torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(dev, dtype)
    w1, w2 = (rng.randn(3, 3, c, c).astype(np.float32) / np.sqrt(9 * c) for _ in range(2))
    b1, b2 = (rng.randn(c).astype(np.float32) * 0.1 for _ in range(2))
    return x, [torch.from_numpy(a).to(dev) for a in (w1, b1, w2, b2)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [
    (2, 32, 32, 32), (2, 16, 16, 64), (1, 8, 12, 128), (2, 8, 8, 256), (1, 5, 7, 12),
    # the four W32 branch shapes, and H, W off the tile grid with C = 12, 48 (padded to 16, 64)
    (2, 128, 128, 32), (2, 64, 64, 64), (2, 32, 32, 128), (2, 16, 16, 256),
    (2, 19, 9, 12), (1, 21, 37, 48), (1, 9, 23, 128), (1, 13, 11, 256), (3, 17, 9, 256),
])
def test_fused_basic_block_kernel_vs_plain(dev, shape, dtype):
    """float32 as 3xTF32, bfloat16 as bf16 products (against the plain
    version on bf16-rounded weights), both on the tensor cores; a second
    call on weights packed once gives the same bits."""
    from human_pose_tpu_torch.ops.cuda_conv import fused_basic_block_packed, pack_block_weights

    x, ws = _block_inputs(shape, dev, dtype)
    want = fused_basic_block_plain(x, *ws).float()
    before = fused_basic_block.launches
    got = fused_basic_block(x, *ws)
    torch.cuda.synchronize()
    assert fused_basic_block.launches == before + 1
    assert got.dtype == dtype and got.shape == x.shape
    err = float((got.float() - want).abs().max())
    tol = 1e-4 if dtype == torch.float32 else 2 ** -6 * float(want.abs().max())
    assert err <= tol, (err, tol)
    assert torch.equal(fused_basic_block_packed(x, *pack_block_weights(*ws, dtype=dtype)), got)


@pytest.mark.parametrize("shape", [(2, 32, 32, 32), (2, 16, 16, 256)])
def test_fused_basic_block_f32_scaled_input(dev, shape):
    """float32 x scaled by 64: within 1e-4 of the output's scale (the split
    loses about 2**-21 of each term, whatever its size)."""
    x, ws = _block_inputs(shape, dev, torch.float32)
    x = x * 64
    want = fused_basic_block_plain(x, *ws)
    err = float((fused_basic_block(x, *ws) - want).abs().max())
    assert err <= 1e-4 * float(want.abs().max()), err


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_basic_block_packed_counts_each_launch(dev, dtype):
    """One counted launch per call on weights packed once, and the same bits
    every call."""
    from human_pose_tpu_torch.ops.cuda_conv import fused_basic_block_packed, pack_block_weights

    x, ws = _block_inputs((2, 24, 20, 64), dev, dtype)
    packed = pack_block_weights(*ws, dtype=dtype)
    before = fused_basic_block.launches
    outs = [fused_basic_block_packed(x, *packed) for _ in range(3)]
    torch.cuda.synchronize()
    assert fused_basic_block.launches == before + 3
    assert all(torch.equal(o, outs[0]) for o in outs[1:])


@pytest.mark.parametrize("c,hw", [(32, 128), (64, 64), (128, 32), (256, 16)])
def test_fused_basic_block_folded_w32_block(dev, c, hw):
    """A W32 branch's BasicBlock with LeCun-normal weights and seeded BN
    statistics, folded: the float32 kernel within 1e-4 of the block's own
    eval forward (cuDNN, TF32 off), batch 24 as on the main path. Folded BN
    scales up to ~1.8 make these sums larger than the random-weight cases."""
    from human_pose_tpu_torch.models import init_flax_default_
    from human_pose_tpu_torch.models.hrnet import BasicBlock
    from human_pose_tpu_torch.ops import fold_basic_block

    gen = torch.Generator().manual_seed(c)
    blk = init_flax_default_(BasicBlock(c, c), gen).eval()
    with torch.no_grad():
        for bn in (blk.bn1, blk.bn2):
            bn.weight.copy_(1.0 + 0.1 * torch.randn(c, generator=gen))
            bn.bias.copy_(0.1 * torch.randn(c, generator=gen))
            bn.running_mean.copy_(0.1 * torch.randn(c, generator=gen))
            bn.running_var.copy_(0.5 + torch.rand(c, generator=gen))
    blk = blk.to(dev)
    x = torch.rand((24, hw, hw, c), generator=gen).to(dev)
    with torch.no_grad():
        want = blk(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    err = float((fused_basic_block(x, *fold_basic_block(blk)) - want).abs().max())
    assert err <= 1e-4, err


def test_decode_fused_card_equals_cpu(dev):
    """The fused front end on the card vs the CPU path (plain kernels) on the
    same stage maps: the same persons, coordinates and scores within 1e-6."""
    rng = np.random.RandomState(1)
    n, k, h4 = 2, 17, 32
    q = rng.rand(n, k, h4, h4).astype(np.float32) * 0.02
    tg = rng.randn(n, k, h4, h4).astype(np.float32) * 0.05
    for i in range(n):
        for person in range(8):
            for j in range(k):
                y, x = rng.randint(2, h4 - 2), rng.randint(2, h4 - 2)
                q[i, j, y, x] = 0.5 + 0.5 * rng.rand()
                tg[i, j, y - 1:y + 2, x - 1:x + 2] = 3.0 * person + rng.randn(3, 3) * 0.01
    h2 = np.repeat(np.repeat(q, 2, axis=2), 2, axis=3) * 0.5
    stages = [torch.from_numpy(q), torch.from_numpy(h2)]
    tags = [torch.from_numpy(tg)]
    cj, cs, cv = decode_batch_fused(stages, tags, (4 * h4, 4 * h4), det_thr=0.05, tag_thr=0.5)
    gj, gs, gv = decode_batch_fused([s.to(dev) for s in stages], [t.to(dev) for t in tags],
                                    (4 * h4, 4 * h4), det_thr=0.05, tag_thr=0.5)
    assert torch.equal(gv.cpu(), cv) and int(cv.sum()) >= 2 * 8
    assert torch.allclose(gj.cpu(), cj, atol=1e-6, rtol=0)
    assert torch.allclose(gs.cpu(), cs, atol=1e-6, rtol=0)


# -- the inference model's path: E=2 (flip) at a non-square decode size ------

def _scene_512x704(seed, e=2, n_persons=12):
    """A full-resolution decode scene at 512x704 with E tag maps: persons
    with one joint peak each per map and their tags around it."""
    rng = np.random.RandomState(seed)
    k, h, w = 17, 512, 704
    hm = rng.rand(1, k, h, w).astype(np.float32) * 0.02
    tg = rng.randn(1, k, e, h, w).astype(np.float32) * 0.05
    for person in range(n_persons):
        for j in range(k):
            y, x = rng.randint(2, h - 2), rng.randint(2, w - 2)
            hm[0, j, y, x] = 0.5 + 0.5 * rng.rand()
            tg[0, j, :, y - 2:y + 3, x - 2:x + 3] = (3.0 * person + np.arange(e)[:, None, None]
                                                     + rng.randn(e, 5, 5) * 0.01)
    return torch.from_numpy(hm), torch.from_numpy(tg)


def test_refine_kernel_e2_at_512x704(dev):
    """The dense refine at the flip path's E=2 on a 512x704 decode."""
    hm, tags, prev = _refine_inputs(20, 1, 17, 512 * 704, 2, 30)
    counts = torch.tensor([30], dtype=torch.int32)
    want = refine_argmax_batch_plain(hm, tags, prev, counts)
    assert torch.equal(_refine_on_card(dev, hm, tags, prev, counts), want)


def test_decode_e2_at_512x704_card_equals_cpu(dev):
    """The inference model's decode (one full-resolution stage, two tag maps)
    at 512x704: card == CPU path, and the grouping kernel == its plain
    version on the decode's own candidates."""
    from human_pose_tpu_torch.ops.grouping import _candidates, joints_order_for, top_k

    hm, tg = _scene_512x704(21)
    tags_list = [tg[:, :, 0], tg[:, :, 1]]
    cj, cs, cv = decode_batch([hm], tags_list, (512, 704), det_thr=0.05, tag_thr=0.5)
    gj, gs, gv = decode_batch([hm.to(dev)], [t.to(dev) for t in tags_list], (512, 704),
                              det_thr=0.05, tag_thr=0.5)
    assert torch.equal(gv.cpu(), cv) and int(cv.sum()) >= 12
    assert torch.equal(gj.cpu()[..., :3], cj[..., :3])
    order = joints_order_for(17)
    cand = _candidates(*top_k(hm.to(dev), tg.to(dev), 30))[:, list(order)].contiguous()
    assert cand.shape == (1, 17, 30, 5)
    want_j, want_c = match_by_tag_batched_plain(cand.cpu(), 0.05, 0.5, order, 30)
    got_j, got_c = match_by_tag_batched(cand, 0.05, 0.5, order, 30)
    assert torch.equal(got_c.cpu(), want_c) and torch.equal(got_j.cpu(), want_j)


@pytest.mark.parametrize("hw", [(32, 44), (16, 22), (64, 44), (256, 352)])
def test_resize_bilinear_card_equals_cpu(dev, hw):
    """The repaired resize (antialiased when it downsamples) on the card vs
    the CPU, from a 64x88 map, within 1e-6."""
    from human_pose_tpu_torch.ops import resize_bilinear

    x = torch.from_numpy(np.random.RandomState(22).randn(2, 17, 64, 88).astype(np.float32))
    err = (resize_bilinear(x.to(dev), *hw).cpu() - resize_bilinear(x, *hw)).abs().max()
    assert float(err) <= 1e-6


def _paint_fixture_image(seed, size=96):
    """uint8 HWC: two persons in tinted bands, 17 joint-coloured discs each,
    like the AP fixture's corpus (tests/ap_fixture.py)."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:size, 0:size]
    img = (rng.rand(size, size, 3) * 25).astype(np.float32)
    colors = rng.randint(60, 256, (9, 3))
    for band, tint in enumerate(((20, 50, 20), (50, 20, 50))):
        y0 = band * size // 2
        img[y0:y0 + size // 2] += tint
        for k in range(17):
            cx, cy = rng.randint(7, size - 7), y0 + rng.randint(7, size // 2 - 7)
            img[(xx - cx) ** 2 + (yy - cy) ** 2 <= 49] = colors[0 if k == 0 else 1 + (k - 1) // 2]
    return np.clip(img, 0, 255).astype(np.uint8)


@pytest.mark.parametrize("config", [{}, {"use_flip": True, "scales": (0.5, 1.0)},
                                    {"use_flip": True, "compact_inputs": True, "pad_multiple": 128}])
def test_fixture_inference_card_equals_cpu(dev, config):
    """The trained C=8 fixture through InferenceKeypointsModel on the card and
    on the CPU: the same decisions (person counts, median joint difference
    < 0.5 px, sorted person scores within 0.05)."""
    from pathlib import Path

    from human_pose_tpu_torch.inference import InferenceKeypointsModel, load_inference_weights
    from human_pose_tpu_torch.models import HigherHRNet

    sd = load_inference_weights(Path(__file__).parent / "data" / "ap_fixture_weights.npz")
    kw = dict(det_thr=0.25, tag_thr=0.4, input_size=64, max_num_people=10, **config)
    runs = []
    for device in ("cpu", dev):
        net = HigherHRNet(num_kpts=17, C=8, device=device).eval()
        net.load_state_dict(sd)
        im = InferenceKeypointsModel(net, device=device, **kw)
        runs.append([im(_paint_fixture_image(seed)) for seed in (0, 1)])
    for want, got in zip(*runs):
        assert len(got.kpts_coords) == len(want.kpts_coords) >= 1
        assert np.median(np.abs(got.kpts_coords - want.kpts_coords)) < 0.5
        assert np.abs(np.sort(got.obj_scores) - np.sort(want.obj_scores)).max() < 0.05


@pytest.mark.parametrize("n_scales", [1.0, 2.0, 3.0])
def test_scale_average_card_equals_cpu(dev, n_scales):
    """``_decode_aggregated``'s scale average is the same true division on
    the card as on the CPU (a Python-scalar divisor would make the CUDA
    kernel multiply by the reciprocal, an ulp off for 3 scales)."""
    from human_pose_tpu_torch.inference import InferenceKeypointsModel
    from human_pose_tpu_torch.models import HigherHRNet

    rng = np.random.RandomState(23)
    avg_sum = torch.from_numpy((rng.rand(1, 17, 64, 96) * 6000).astype(np.float32))
    tags = [torch.from_numpy(rng.randn(1, 17, 64, 96).astype(np.float32))]
    outs = []
    for device in ("cpu", dev):
        net = HigherHRNet(num_kpts=17, C=8, num_blocks_per_stage=(1, 1, 1, 1), num_units=1,
                         num_deconv_resid_blocks=1, device=device).eval()
        im = InferenceKeypointsModel(net, input_size=64, device=device)
        outs.append(im._decode_aggregated(avg_sum.to(device), [t.to(device) for t in tags],
                                          (64, 96), n_scales, (64, 80)))
    (cj, _, cv, cavg, _), (gj, _, gv, gavg, _) = outs
    assert torch.equal(gavg.cpu(), cavg)
    assert torch.equal(gv.cpu(), cv) and torch.equal(gj.cpu()[..., :3], cj[..., :3])


# -- batched COCO eval on the trained C=8 corpus (tests/ap_fixture.py) --------

def _assert_detections_match(serial, batched, coord_tol=0.5):
    """tests/test_batched_eval.py's ``assert_detections_match`` (that module
    imports the JAX package, which this file must not): the same images and
    person counts, each person's joints within ``coord_tol`` px and its
    score within 1e-3 of its best match."""
    by_image = lambda dets: {d["image_id"]: [e for e in dets if e["image_id"] == d["image_id"]]  # noqa: E731
                             for d in dets}
    s, b = by_image(serial), by_image(batched)
    assert set(s) == set(b)
    for image_id in s:
        sd, bd = s[image_id], b[image_id]
        assert len(sd) == len(bd), f"image {image_id}: {len(sd)} vs {len(bd)} persons"
        used = set()
        for det in sd:
            sk = np.asarray(det["keypoints"], np.float64).reshape(-1, 3)[:, :2]
            errs = [(np.abs(sk - np.asarray(c["keypoints"], np.float64).reshape(-1, 3)[:, :2]).max(), j)
                    for j, c in enumerate(bd) if j not in used]
            best_err, best = min(errs)
            assert best_err < coord_tol, f"image {image_id}: max coord err {best_err}"
            assert abs(det["score"] - bd[best]["score"]) < 1e-3
            used.add(best)


@pytest.fixture(scope="module")
def fixture_eval(dev, tmp_path_factory):
    """tests/ap_fixture.py's corpus (10 images of 96x96, 2 persons each),
    built from its image list (tests/test_data.py, which writes that list,
    imports the JAX package), pre-baked, and a factory of inference models
    on the trained fixture weights, flip on, at the AP check's eval point."""
    import json
    from pathlib import Path

    from human_pose_tpu_torch.data import CocoKeypointsDataset, prebake_annotations
    from human_pose_tpu_torch.inference import InferenceKeypointsModel, load_inference_weights
    from human_pose_tpu_torch.models import HigherHRNet
    from tests.ap_fixture import N_IMAGES, WEIGHTS_PATH, make_learnable_fixture

    root = tmp_path_factory.mktemp("eval") / "coco"
    (root / "images" / "val2017").mkdir(parents=True)
    (root / "annotations").mkdir()
    gt = {"images": [{"id": i, "file_name": f"{i:012d}.jpg", "height": 96, "width": 96}
                     for i in range(N_IMAGES)]}
    make_learnable_fixture(root, gt)
    assert json.loads((root / "annotations" / "person_keypoints_val2017.json").read_text())
    prebake_annotations(str(root), "val2017")
    ds = CocoKeypointsDataset(str(root), "val2017")
    sd = load_inference_weights(WEIGHTS_PATH)
    nets = {}
    for device in ("cpu", dev):
        nets[str(device)] = HigherHRNet(num_kpts=17, C=8, device=device).eval()
        nets[str(device)].load_state_dict(sd)

    def model(device, **kw):
        return InferenceKeypointsModel(nets[str(device)], device=device, det_thr=0.25, tag_thr=0.4,
                                       input_size=64, max_num_people=10, use_flip=True, **kw)
    assert Path(ds.images_filepaths[0]).exists() and len(ds) == N_IMAGES
    return ds, model


def _batched(im, ds, batch_size):
    from human_pose_tpu_torch.inference import BatchedKeypointsEvaluator, image_id_from_path

    ev = BatchedKeypointsEvaluator(im, batch_size=batch_size)
    for i in range(len(ds)):
        ev.add(ds.load_image(i), image_id_from_path(ds.images_filepaths[i], i), ds.load_annot(i))
    dets, _ = ev.finish()
    return ev, dets


@pytest.mark.parametrize("pad_multiple", [64, 128])
@pytest.mark.parametrize("batch_size", [2, 4])
def test_batched_eval_matches_serial_on_card(fixture_eval, dev, batch_size, pad_multiple):
    """The batched evaluator on the card equals the serial one within
    tests/test_batched_eval.py's tolerances, launching the dense refine and
    the grouping once a batch (P = 10)."""
    from human_pose_tpu_torch.bin.eval_keypoints import evaluate_dataset

    ds, model = fixture_eval
    im = model(dev, pad_multiple=pad_multiple)
    serial = evaluate_dataset(im, ds)
    refine_argmax_batch.launches = match_by_tag_batched.launches = 0
    ev, batched = _batched(im, ds, batch_size)
    assert ev.n_batches == -(-len(ds) // batch_size) and len(ev.buckets) == 1
    assert refine_argmax_batch.launches == match_by_tag_batched.launches == ev.n_batches
    assert len({d["image_id"] for d in batched}) == len(ds)
    _assert_detections_match(serial, batched)


def test_batched_eval_card_equals_cpu(fixture_eval, dev):
    """The batched evaluator's decisions on the card equal the CPU's (pad
    128: each image's pad region masked on the device)."""
    ds, model = fixture_eval
    _, cpu = _batched(model("cpu", pad_multiple=128), ds, 4)
    _, card = _batched(model(dev, pad_multiple=128), ds, 4)
    _assert_detections_match(cpu, card)


def test_batched_decode_per_image_valid_sizes(fixture_eval, dev):
    """A batch-4 decode with four different valid sizes equals the four
    single-image decodes of the same maps, bit for bit."""
    ds, model = fixture_eval
    im = model(dev, pad_multiple=128)
    x = np.stack([im.prepare_input(ds.load_image(i))[0][0] for i in range(4)])
    avg, tags = im.forward_scale(im.to_device(x), (128, 128))
    sizes = [(64, 64), (128, 64), (64, 128), (96, 80)]
    refine_argmax_batch.launches = match_by_tag_batched.launches = 0
    batched = im.decode_masked(avg, tags, (128, 128), 1.0,
                               torch.tensor(sizes, dtype=torch.int32, device=dev))
    assert refine_argmax_batch.launches == match_by_tag_batched.launches == 1
    for i, hw in enumerate(sizes):
        alone = im.decode_masked(avg[i:i + 1], [t[i:i + 1] for t in tags], (128, 128), 1.0, hw)
        for got, want in zip(batched, alone):
            assert torch.equal(got[i:i + 1], want)
    assert int(batched[2].sum()) >= 4


# -- the training slice: prep_images, train-mode BatchNorm, one step ------------

def test_prep_images_card_equals_cpu(dev):
    """All 256 uint8 values in each of the 3 channels normalize to the same
    float32 bits on the card as on the CPU: ``prep_images`` divides by a
    device tensor, not by a Python 255.0 (which CUDA turns into a multiply
    by its reciprocal)."""
    from human_pose_tpu_torch.ops import prep_images

    u8 = torch.arange(256, dtype=torch.uint8)[None, None, :, None].expand(1, 3, 256, 1).contiguous()
    assert torch.equal(prep_images(u8.to(dev)).cpu(), prep_images(u8))


def _batch_norm_card_vs_cpu(dev, dtype, make, groups: int = 1) -> None:
    """One train-mode call of the BatchNorm ``make()`` over ``groups``
    consecutive groups of a batch of 6, on the card and on the CPU, held
    as ``test_batch_norm_train_card_equals_cpu`` says against float64 of
    the same formulas, each group with its own moments."""
    gen = torch.Generator().manual_seed(11)
    x = (torch.randn((6, 32, 24, 20), generator=gen) * (0.1 + 3 * torch.rand((1, 32, 1, 1), generator=gen))
         + torch.randn((1, 32, 1, 1), generator=gen)).to(dtype)
    gy = torch.randn(x.shape, generator=gen).to(dtype)
    w, b = torch.linspace(0.5, 1.5, 32), torch.linspace(-0.2, 0.2, 32)
    stats, outs = [], None
    for where in ("cpu", dev):
        m = make().to(where).train()
        with torch.no_grad():
            m.weight.copy_(w)
            m.bias.copy_(b)
        xx = x.detach().to(where).requires_grad_()
        y = m(xx)
        y.backward(gy.to(where))
        stats.append([t.cpu() for t in (m.running_mean, m.running_var)])
        outs = [t.detach().double().cpu() for t in (y, xx.grad, m.weight.grad, m.bias.grad)]
    for got, want in zip(stats[1], stats[0]):
        assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())

    shape, dims, c = (groups, 6 // groups, 32, 24, 20), (1, 3, 4), (None, None, slice(None), None, None)
    x64, gy64 = x.double().reshape(shape), gy.double().reshape(shape)
    mean = x64.mean(dims, keepdim=True)
    var = (x64 - mean).square().mean(dims, keepdim=True)
    xhat = (x64 - mean) / (var + 1e-5).sqrt()
    sum_w, sum_b = (gy64 * xhat).sum(dims, keepdim=True), gy64.sum(dims, keepdim=True)
    n = x64[0].numel() / 32
    grad_x = w.double()[c] / (var + 1e-5).sqrt() * (gy64 - sum_b / n - xhat * sum_w / n)
    want = [(xhat * w.double()[c] + b.double()[c]).reshape(x.shape), grad_x.reshape(x.shape),
            sum_w.sum(0).flatten(), sum_b.sum(0).flatten()]
    for i, (got, ref) in enumerate(zip(outs, want)):
        tol = 2 ** -7 if dtype == torch.bfloat16 and i < 2 else 1e-4
        err = float((got - ref).abs().max()) / float(ref.abs().max())
        assert err <= tol, (i, err)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_batch_norm_train_card_equals_cpu(dev, dtype):
    """One train-mode call of the port's BatchNorm (flax's: biased E[x^2] -
    E[x]^2 variance) on the card and on the CPU with the same input: the
    running mean and variance within 1e-5 of their largest value (float32
    moments of the same values, summed in other orders). The card's output
    and gradients of x, weight and bias against a float64 evaluation of the
    same formulas on the same values: within 1e-4 of their scale in float32.
    In bfloat16 the output and the gradient of x are bfloat16 tensors, held
    within 2**-7, one bf16 rounding (2.8e-3 on either device); the weight's
    and the bias's gradients are float32 sums, as in JAX's bf16 step, held
    within 1e-4 (the card's own backward kernel gave them at bf16
    precision, 2.3e-3 and 4.4e-3, so the port sums them itself)."""
    from human_pose_tpu_torch.models.norm import batch_norm

    _batch_norm_card_vs_cpu(dev, dtype, lambda: batch_norm(32))


@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_local_batch_norm_train_card_equals_cpu(dev, dtype, groups):
    """``LocalBatchNorm`` (JAX's two-pass moments through the BatchNorm
    kernels; one group is a process's own shard under per-device
    statistics) as ``test_batch_norm_train_card_equals_cpu``, each group
    against float64 of its own moments."""
    from human_pose_tpu_torch.parallel import LocalBatchNorm

    _batch_norm_card_vs_cpu(dev, dtype, lambda: LocalBatchNorm(32, num_groups=groups), groups)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("shape,offset", [
    # the W32 step's BatchNorm shapes at bs36
    ((36, 32, 128, 128), 0), ((36, 64, 64, 64), 0), ((36, 128, 32, 32), 0), ((36, 256, 16, 16), 0),
    ((36, 32, 256, 256), 0),
    # H*W not a multiple of 8, N = 1, C = 1, channels shorter than one block,
    # x 2 bytes past a 16-byte boundary
    ((3, 5, 7, 9), 0), ((1, 16, 24, 24), 0), ((4, 1, 40, 40), 0), ((2, 3, 3, 5), 0),
    ((2, 8, 16, 16), 1), ((80, 96, 7, 7), 0),
])
def test_batch_norm_backward_kernel_vs_plain(dev, shape, offset, dtype):
    """``ops/cuda_norm.py``'s kernel pair against a float64 evaluation of
    its plain version's formulas on the same values: grad_x within one
    rounding of the working type (2**-8 of each element in bf16, 2**-11 in
    fp16, beside 1e-5 of the scale), the float32 weight's and bias's
    gradients within 1e-4 of their scale. Two calls give the same bits; each
    is two counted launches; with no grad_x the parameter gradients are the
    same bits."""
    from human_pose_tpu_torch.ops.cuda_norm import (
        batch_norm_backward, batch_norm_backward_plain, vector_width,
    )

    n, c, h, w = shape
    gen = torch.Generator(device=dev).manual_seed(5)
    x32 = (torch.randn(shape, generator=gen, device=dev)
           * (0.1 + 3 * torch.rand((1, c, 1, 1), generator=gen, device=dev))
           + torch.randn((1, c, 1, 1), generator=gen, device=dev))
    x = torch.empty(x32.numel() + offset, dtype=dtype, device=dev)[offset:].view(shape)
    x.copy_(x32)
    gy = torch.randn(shape, generator=gen, device=dev).to(dtype)
    weight = torch.linspace(0.5, 1.5, c, device=dev)
    mean = x.float().mean((0, 2, 3))
    invstd = torch.rsqrt((x.float() - mean[:, None, None]).square().mean((0, 2, 3)) + 1e-5)
    assert vector_width(h * w, x, gy) == (8 if (h * w) % 8 == 0 and not offset else 1)

    batch_norm_backward.launches = 0
    got = batch_norm_backward(gy, x, weight, mean, invstd)
    again = batch_norm_backward(gy, x, weight, mean, invstd)
    no_x = batch_norm_backward(gy, x, weight, mean, invstd, need_x=False)
    torch.cuda.synchronize()
    assert batch_norm_backward.launches == 6
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert no_x[0] is None and torch.equal(no_x[1], got[1]) and torch.equal(no_x[2], got[2])

    x64, gy64, cc = x.double(), gy.double(), (None, slice(None), None, None)
    m64, is64 = mean.double(), invstd.double()
    sum_b = gy64.sum((0, 2, 3))
    sum_w = (gy64 * (x64 - m64[cc])).sum((0, 2, 3)) * is64
    want = (weight.double() * is64)[cc] * (gy64 - sum_b[cc] / (n * h * w)
                                           - (x64 - m64[cc]) * is64[cc] * sum_w[cc] / (n * h * w))
    grad_x, grad_w, grad_b = got
    assert grad_x.dtype == dtype and grad_w.dtype == grad_b.dtype == torch.float32
    ulp = 2 ** -8 if dtype == torch.bfloat16 else 2 ** -11
    plain = batch_norm_backward_plain(gy, x, weight, mean, invstd)[0].double()
    for ref, rounds in ((want, 1), (plain, 2)):  # the plain version rounds once too
        err = (grad_x.double() - ref).abs() - rounds * ulp * ref.abs()
        assert float(err.max()) <= 1e-5 * float(want.abs().max()), (rounds, float(err.max()))
    for got_p, want_p in ((grad_w, sum_w), (grad_b, sum_b)):
        assert float((got_p.double() - want_p).abs().max()) <= 1e-4 * float(want_p.abs().max())


def test_batch_norm_backward_kernel_refusals(dev):
    """The wrapper raises on what the kernel pair does not take: a
    non-contiguous x, a grad_y of another dtype or shape, float32 x."""
    from human_pose_tpu_torch.ops.cuda_norm import batch_norm_backward

    x = torch.randn((2, 4, 8, 8), device=dev, dtype=torch.bfloat16)
    stats = [torch.ones(4, device=dev) for _ in range(3)]
    with pytest.raises(ValueError):
        batch_norm_backward(x.transpose(2, 3), x.transpose(2, 3), *stats)
    with pytest.raises(ValueError):
        batch_norm_backward(x.half(), x, *stats)
    with pytest.raises(ValueError):
        batch_norm_backward(x[:1], x, *stats)
    with pytest.raises(ValueError):
        batch_norm_backward(x.float(), x.float(), *stats)


def test_higher_hrnet_w32_bf16_step_launches_batch_norm_backward_per_layer(dev):
    """A bfloat16 Adam step of the full-width HigherHRNet-W32 (batch 2 at
    128^2) takes every BatchNorm backward through the kernel pair: 2
    launches for each of the 301 train-mode BatchNorm layers the forward
    ran; the float32 step launches none (``native_batch_norm_backward``)."""
    from human_pose_tpu_torch.bin import bench_train
    from human_pose_tpu_torch.models import HigherHRNet, init_flax_default_
    from human_pose_tpu_torch.models.norm import BatchNorm2d
    from human_pose_tpu_torch.ops.cuda_norm import batch_norm_backward
    from human_pose_tpu_torch.train import TrainState, create_optimizer, keypoints_train_step

    for dtype, per_layer in ((torch.bfloat16, 2), (torch.float32, 0)):
        model = HigherHRNet(num_kpts=17, C=32, device=dev)
        init_flax_default_(model, torch.Generator().manual_seed(0))
        ran = []
        for m in model.modules():
            if isinstance(m, BatchNorm2d):
                m.register_forward_hook(lambda mod, i, o: ran.append(mod))
        state = TrainState.create(model, create_optimizer(model.parameters(), "Adam", 1e-3),
                                  dtype=dtype, device=dev)
        batch_norm_backward.launches = 0
        metrics = keypoints_train_step(state, bench_train.synth_batch(0, 2, 128, dev), 1e-3)[1]
        torch.cuda.synchronize()
        assert len(ran) == 301 and all(np.isfinite(float(v)) for v in metrics.values())
        assert batch_norm_backward.launches == per_layer * len(ran)


def test_train_step_reduced_card_equals_cpu(dev):
    """One float32 Adam step of the reduced HigherHRNet (C=8, one unit a
    stage, one deconv residual block; batch 4 at 128^2) on the card and on
    the CPU from the same weights and batch: ``chip_smoke``'s phase 9 check
    and its tolerances (loss terms rel 1e-4, gradients within 1e-3 of a
    float64 evaluation on the CPU, BN statistics, parameters after the
    step)."""
    import chip_smoke

    out = chip_smoke.train_step_card_vs_cpu(dev)
    assert out["loss_rel"] <= 1e-4 and out["grad_rel_max"] <= 1e-3


# -- the training input pipeline: the native splat, the device prefetch, a module step -----

def test_native_splat_built_and_matches_plain(dev):
    """The native splat (a host C++ library built at first use) against its
    plain NumPy loop at the yaml's heatmap sizes and sigma, 30 persons with
    joints off the maps and invisible: within 1e-6 (exact on the CPU)."""
    from human_pose_tpu_torch.data import HeatmapGenerator

    rs = np.random.RandomState(3)
    for size in (128, 256):
        gen = HeatmapGenerator(17, size, 2.0)
        joints = np.stack([rs.randint(-3, size + 3, (30, 17)), rs.randint(-3, size + 3, (30, 17)),
                           rs.randint(0, 3, (30, 17))], -1).astype(np.int32)
        assert np.abs(gen(joints) - gen.plain(joints)).max() <= 1e-6
        assert gen.native_calls == 1


def _host_batch(seed: int, compact: bool, n: int = 3, size: int = 64, p: int = 5) -> dict:
    """A collate-shaped host batch: channel-last images and heatmaps, masks
    and joints; compact: uint8, float16 and bool."""
    rs = np.random.RandomState(seed)
    images = rs.randint(0, 256, (n, size, size, 3)).astype(np.uint8)
    hms = [rs.rand(n, size // d, size // d, 17).astype(np.float16 if compact else np.float32)
           for d in (4, 2)]
    masks = [rs.rand(n, size // d, size // d) > 0.1 for d in (4, 2)]
    joints = np.stack([rs.randint(0, size // 4, (n, p, 17)), rs.randint(0, size // 4, (n, p, 17)),
                       rs.randint(0, 2, (n, p, 17))], -1).astype(np.int32)
    if not compact:
        images = (images.astype(np.float32) - 128) / 64
        masks = [m.astype(np.float32) for m in masks]
    return {"images": images, "heatmaps": hms, "masks": masks, "joints": joints}


@pytest.mark.parametrize("compact", [False, True])
@pytest.mark.parametrize("pin_memory", [False, True])
def test_prefetched_batch_card_equals_cpu(dev, compact, pin_memory):
    """Batches through ``DevicePrefetcher`` on the card (side stream, event,
    ``record_stream``; pinned staging or not) equal the same host batches
    moved to the CPU layout, bit for bit: NCHW images and heatmaps,
    contiguous, dtypes kept, on the card, in order."""
    from human_pose_tpu_torch.train import DeviceBatch, DevicePrefetcher, host_batch_to_device

    batches = [_host_batch(s, compact) for s in range(4)]
    pf = DevicePrefetcher(batches, lambda b: host_batch_to_device(b, dev, pin_memory=pin_memory),
                          buffer=2, device=dev)
    got = []
    for batch in pf:
        assert isinstance(batch, DeviceBatch)
        got.append({k: [t.clone() for t in v] if isinstance(v, list) else v.clone()
                    for k, v in batch.items()})
        torch.cuda._sleep(1_000_000)  # the next batch's copy overlaps work on the compute stream
    torch.cuda.synchronize()
    assert len(got) == len(batches)
    for g, b in zip(got, batches):
        want = host_batch_to_device(b, torch.device("cpu"))
        for key in want:
            pairs = zip(g[key], want[key]) if isinstance(want[key], list) else [(g[key], want[key])]
            for t, w in pairs:
                assert t.device == dev and t.is_contiguous() and t.dtype == w.dtype, key
                assert torch.equal(t.cpu(), w), key


def test_keypoints_module_step_card_equals_cpu(dev):
    """``KeypointsModule.training_step`` on a channel-last host batch (the
    module puts it on its device in NCHW) of the reduced HigherHRNet, card
    against CPU from the same weights, float32 with TF32 off: the loss terms
    within rel 1e-4, and every gradient within ||card - ref|| / ||ref|| 1e-3
    of ``ref``, the same gradients in float64 on the CPU (``chip_smoke``'s
    phase 9 tolerances; the CPU's float32 gradients are not the reference:
    on this batch they miss float64 by more than the card's);
    ``validation_step`` before
    it (eval BatchNorm from the same statistics): metrics within rel 1e-4."""
    import copy

    from human_pose_tpu_torch.models import HigherHRNet
    from human_pose_tpu_torch.ops import prep_images
    from human_pose_tpu_torch.train import KeypointsModule, ae_keypoints_loss, host_batch_to_device

    reduced = dict(num_kpts=17, C=8, num_blocks_per_stage=(1, 1, 1, 1), num_units=1,
                   num_deconv_resid_blocks=1)
    cpu = KeypointsModule.create(HigherHRNet(**reduced, device="cpu"), seed=4)
    card = KeypointsModule.create(copy.deepcopy(cpu.model).to(dev), seed=4)
    card.model.load_state_dict(cpu.model.state_dict())
    batch = _host_batch(7, compact=True, n=4, size=128)
    ref = copy.deepcopy(cpu.model).double().train()
    nchw = host_batch_to_device(batch, torch.device("cpu"))
    total, _ = ae_keypoints_loss(*ref(prep_images(nchw["images"]).double()), nchw["heatmaps"],
                                 nchw["masks"], nchw["joints"])
    total.backward()
    for (v_cpu, _), (v_card, _) in [(cpu.validation_step(batch), card.validation_step(batch))]:
        for key, value in v_cpu.items():
            assert abs(float(v_card[key]) - float(value)) <= 1e-4 * abs(float(value)), key
    m_cpu, m_card = cpu.training_step(batch), card.training_step(batch)
    for key, value in m_cpu.items():
        assert abs(float(m_card[key]) - float(value)) <= 1e-4 * abs(float(value)), key
    for (name, r), q in zip(ref.named_parameters(), card.model.parameters()):
        rel = float((q.grad.cpu().double() - r.grad).norm() / r.grad.norm().clamp(min=1e-30))
        assert rel <= 1e-3, (name, rel)


# -- the training engine: checkpoints on the card, the reduced run card vs CPU ------

_REDUCED = dict(num_kpts=17, C=8, num_blocks_per_stage=(1, 1, 1, 1), num_units=1,
                num_deconv_resid_blocks=1)


def _clone_state(module) -> tuple:
    return ({k: v.detach().clone() for k, v in module.model.state_dict().items()},
            {i: {k: v.clone() if torch.is_tensor(v) else v for k, v in s.items()}
             for i, s in module.state.optimizer.state_dict()["state"].items()})


def _assert_same_state(ckpt: dict, model_sd: dict, opt_state: dict) -> None:
    for k, v in model_sd.items():
        got = ckpt["module"]["model"][k]
        assert got.device.type == "cpu" and torch.equal(got, v.cpu()), k
    for i, s in opt_state.items():
        for k, v in s.items():
            got = ckpt["module"]["optimizers"]["optim"]["state"][i][k]
            assert torch.equal(got, v.cpu()) if torch.is_tensor(v) else got == v, (i, k)


def test_async_checkpoint_snapshot_on_card(dev, tmp_path):
    """``AsyncCheckpointWriter.submit`` on the card while batches arrive
    through ``DevicePrefetcher`` (its side stream copying the next batches):
    the file holds the model and Adam's state of the submit, bit for bit,
    although two more steps updated them in place before the write was
    joined."""
    from human_pose_tpu_torch.models import HigherHRNet
    from human_pose_tpu_torch.train import (
        AsyncCheckpointWriter, DevicePrefetcher, KeypointsModule, load_checkpoint,
    )

    module = KeypointsModule.create(HigherHRNet(**_REDUCED, device=dev), seed=1)
    batches = [_host_batch(s, compact=True, n=4, size=128) for s in range(4)]
    it = iter(DevicePrefetcher(batches, module.batch_to_device, buffer=2, device=dev))
    module.training_step(next(it))
    torch.cuda.synchronize()
    model_sd, opt_state = _clone_state(module)
    writer = AsyncCheckpointWriter()
    writer.submit(tmp_path / "last.pt", module.state, epoch=0)
    module.training_step(next(it))
    module.training_step(next(it))
    writer.wait()
    ckpt = load_checkpoint(tmp_path / "last.pt")
    assert ckpt["module"]["step"] == 1 and module.state.step == 3
    _assert_same_state(ckpt, model_sd, opt_state)
    assert not all(torch.equal(v, module.model.state_dict()[k]) for k, v in model_sd.items())


def test_card_checkpoint_loads_on_cpu(dev, tmp_path):
    """A checkpoint saved on the card (synchronously and by the writer)
    reads back on the CPU (``weights_only``), restores a CPU module's model
    and Adam state exactly, and loads strictly for inference."""
    from human_pose_tpu_torch.inference import load_inference_weights
    from human_pose_tpu_torch.models import HigherHRNet
    from human_pose_tpu_torch.train import (
        AsyncCheckpointWriter, KeypointsModule, load_checkpoint, load_train_state, save_checkpoint,
    )

    module = KeypointsModule.create(HigherHRNet(**_REDUCED, device=dev), seed=2)
    module.training_step(_host_batch(5, compact=True, n=4, size=128))
    model_sd, opt_state = _clone_state(module)
    save_checkpoint(tmp_path / "sync.pt", module.state, epoch=3,
                    lr_schedulers=module.schedulers_state_dict())
    writer = AsyncCheckpointWriter()
    writer.submit(tmp_path / "async.pt", module.state, epoch=3)
    writer.wait()
    for name in ("sync.pt", "async.pt"):
        ckpt = load_checkpoint(tmp_path / name)
        _assert_same_state(ckpt, model_sd, opt_state)
        cpu = KeypointsModule.create(HigherHRNet(**_REDUCED, device="cpu"), seed=9)
        load_train_state(cpu.state, ckpt)
        assert cpu.state.step == 1
        for k, v in cpu.model.state_dict().items():
            assert torch.equal(v, model_sd[k].cpu()), k
        for (_, p), (_, q) in zip(cpu.model.named_parameters(), module.model.named_parameters()):
            s, t = cpu.state.optimizer.state[p], module.state.optimizer.state[q]
            assert s["exp_avg"].device.type == "cpu" and torch.equal(s["exp_avg"], t["exp_avg"].cpu())
        HigherHRNet(**_REDUCED, device="cpu").load_state_dict(
            load_inference_weights(tmp_path / name), strict=True)


def test_engine_reduced_card_equals_cpu(dev, tmp_path):
    """``chip_smoke``'s phase 11 check: the reduced net trained through
    ``bin.train_keypoints.main`` for two epochs of two batches on the card
    and on the CPU (float32, cuDNN off) on a synthesized directory, with
    Adam and with SGD: both first steps' loss terms within rel 1e-4; SGD's
    later steps and epoch means within ``chip_smoke.ENGINE_SGD_RTOL`` (1e-3)
    of the larger of the term and the loss (Adam's later steps amplify
    summation-order differences: see the constant's comment)."""
    from pathlib import Path

    import chip_smoke

    rng = np.random.default_rng(5)
    root = tmp_path / "coco"
    for split in ("train2017", "val2017"):
        chip_smoke.make_eval_corpus(root, rng, split, 8, (2, 6), 4)
    yaml_path = str(Path(chip_smoke.__file__).resolve().parent / chip_smoke.TRAIN_YAML)
    out = chip_smoke.engine_card_vs_cpu(
        dev, yaml_path, [f"--dataloader.train_ds.root={root}", f"--dataloader.val_ds.root={root}"],
        tmp_path / "runs")
    tol = chip_smoke.ENGINE_SGD_RTOL
    assert out["adam"]["first_rel"] <= 1e-4 and out["sgd"]["first_rel"] <= 1e-4
    assert out["sgd"]["later_rel_of_scale"] <= tol and out["sgd"]["epochs_rel_of_scale"] <= tol
    assert len(out["sgd"]["loss_card"]) == 4


# -- ImageNet classification -----------------------------------------------------------------

@pytest.mark.parametrize("batch_size", [8, 4])
def test_classification_step_reduced_card_equals_cpu(dev, batch_size):
    """``chip_smoke``'s phase 12 check: one float32 SGD step (nesterov,
    weight decay, TF32 and cuDNN off) of the reduced ClassificationHRNet
    (C=8, 1000 classes, batch 8 and batch 4 at 64^2) on the card and on the
    CPU: the loss within rel 1e-4, each device's gradients within 1e-3 of
    a float64 evaluation on the CPU with that device's ReLU decisions, BN
    statistics; where card and CPU decide alike, the card's gradients and
    the parameters' updates within 1e-3 of the CPU's."""
    import chip_smoke

    out = chip_smoke.classification_step_card_vs_cpu(dev, batch_size)
    assert out["loss_rel"] <= 1e-4 and out["grad_rel_max"] <= 1e-3
    if out["relu"]["card_vs_cpu_differ"] == 0:
        assert out["grad_rel_vs_cpu_max"] <= 1e-3 and out["update_rel_max"] <= 1e-3


def _reduced_classifier(device, seed: int = 2):
    from human_pose_tpu_torch.models import ClassificationHRNet, init_classification_weights_

    net = ClassificationHRNet(C=8, num_classes=10, num_blocks_per_stage=(1, 1, 1, 1), num_units=1,
                              device="cpu")
    return init_classification_weights_(net, torch.Generator().manual_seed(seed)).to(device)


def test_classification_bf16_step_keeps_float32_bn_grads(dev):
    """A bfloat16 classification step (autocast) on the card: every
    parameter, its gradient and SGD's momentum stay float32, the BatchNorm
    weights' and biases' gradients among them (the port sums them in
    float32, ``models/norm.py``), finite; the loss is float32 and within 5%
    of the float32 step's from the same weights."""
    from human_pose_tpu_torch.models.norm import BatchNorm2d
    from human_pose_tpu_torch.train import TrainState, classification_train_step, create_optimizer

    gen = torch.Generator(device=dev).manual_seed(3)
    images = torch.randint(0, 256, (8, 3, 64, 64), dtype=torch.uint8, generator=gen, device=dev)
    labels = torch.randint(0, 10, (8,), generator=gen, device=dev)
    losses = {}
    for dtype in (torch.float32, torch.bfloat16):
        net = _reduced_classifier(dev)
        opt = create_optimizer(net.parameters(), "SGD", 0.1, momentum=0.9, nesterov=True)
        state = TrainState.create(net, opt, dtype=dtype, device=dev)
        _, metrics = classification_train_step(state, images, labels, 0.1)
        losses[dtype] = metrics["loss"]
    assert losses[torch.bfloat16].dtype == torch.float32
    assert abs(float(losses[torch.bfloat16]) - float(losses[torch.float32])) <= 0.05 * float(losses[torch.float32])
    bn = [m for m in net.modules() if isinstance(m, BatchNorm2d)]
    assert bn
    for m in bn:
        for p in (m.weight, m.bias):
            assert p.grad.dtype == torch.float32 and bool(torch.isfinite(p.grad).all())
    for p in net.parameters():
        assert p.dtype == torch.float32 and p.grad.dtype == torch.float32
        assert opt.state[p]["momentum_buffer"].dtype == torch.float32


@pytest.mark.parametrize("compact", [False, True])
def test_inference_classification_card_equals_cpu(dev, compact):
    """``InferenceClassificationModel`` of the reduced net on the card and
    on the CPU from the same weights, float32 with TF32 off, on two raw
    images: the model input equal, the probabilities within 1e-5, the
    batched ``probs`` on the card within 1e-6 of its calls one by one."""
    from human_pose_tpu_torch.inference import InferenceClassificationModel

    net = _reduced_classifier("cpu").eval()
    models = {where: InferenceClassificationModel(_reduced_classifier(where).eval(), input_size=64,
                                                  compact_inputs=compact, device=where)
              for where in ("cpu", dev)}
    for m in models.values():
        m.model.load_state_dict(net.state_dict())
    rs = np.random.RandomState(4)
    raws = [rs.randint(0, 256, hw + (3,)).astype(np.uint8) for hw in ((375, 500), (500, 333))]
    for raw in raws:
        got, want = models[dev](raw), models["cpu"](raw)
        assert np.array_equal(got.image, want.image)
        assert float(np.abs(got.probs - want.probs).max()) <= 1e-5
    card = models[dev]
    xs = np.stack([card.transform.inference(r) for r in raws])
    batched = card.probs(card.to_device(xs)).cpu().numpy()
    assert np.abs(batched - np.stack([card(r).probs for r in raws])).max() <= 1e-6


# -- serving and export (inference/serving.py, utils/export.py) -----------------

def _fixture_net(device):
    from pathlib import Path

    from human_pose_tpu_torch.inference import load_inference_weights
    from human_pose_tpu_torch.models import HigherHRNet

    net = HigherHRNet(num_kpts=17, C=8, device=device).eval()
    net.load_state_dict(load_inference_weights(Path(__file__).parent / "data" / "ap_fixture_weights.npz"))
    return net


def _fixture_predictor(device, dtype=torch.float32):
    """``BatchedKeypointsPredictor`` on the trained C=8 fixture at the AP
    check's eval point."""
    from human_pose_tpu_torch.inference import BatchedKeypointsPredictor, InferenceKeypointsModel

    return BatchedKeypointsPredictor(InferenceKeypointsModel(
        _fixture_net(device), det_thr=0.25, tag_thr=0.4, input_size=64, max_num_people=10,
        dtype=dtype, device=device))


@pytest.mark.parametrize("n", [1, 3, 5, 16])
def test_serving_predict_launches_each_decode_kernel_once(dev, n):
    """A predict of ``n`` same-bucket requests (padded to a power of two) is
    one device batch: one launch of the dense refine and of the grouping."""
    pred = _fixture_predictor(dev)
    reqs = [pred.prepare(_paint_fixture_image(i % 4)) for i in range(n)]
    before = (refine_argmax_batch.launches, match_by_tag_batched.launches)
    out = pred.predict(reqs)
    torch.cuda.synchronize()
    assert len(out) == n and all(p["num_people"] >= 1 for p in out)
    assert (refine_argmax_batch.launches - before[0], match_by_tag_batched.launches - before[1]) == (1, 1)


def _people(payload) -> tuple:
    keypoints = np.asarray([p["keypoints"] for p in payload["people"]], np.float64).reshape(-1, 17, 3)
    return keypoints, np.asarray([p["score"] for p in payload["people"]])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_serving_batched_decides_as_single_on_card(dev, dtype):
    """Five requests in one padded batch against each alone, on the card:
    float32 at JAX's serving rule (the same persons, coordinates within
    0.05, scores within 5e-3: the batch size changes only cuDNN's summation
    order); bfloat16, whose activations round to 8 bits, at the level of
    decisions (the same persons, median joint difference < 0.5 px, sorted
    person scores within 0.05)."""
    pred = _fixture_predictor(dev, dtype)
    reqs = [pred.prepare(_paint_fixture_image(seed)) for seed in range(5)]
    for batched, req in zip(pred.predict(reqs), reqs):
        single = pred.predict([req])[0]
        assert batched["num_people"] == single["num_people"] >= 1
        (bk, bs), (sk, ss) = _people(batched), _people(single)
        if dtype == torch.float32:
            assert np.abs(bk[..., :2] - sk[..., :2]).max() <= 0.05
            assert np.abs(bk[..., 2] - sk[..., 2]).max() <= 5e-3 and np.abs(bs - ss).max() <= 5e-3
        else:
            assert np.median(np.abs(bk[..., :2] - sk[..., :2])) < 0.5
            assert np.abs(np.sort(bs) - np.sort(ss)).max() < 0.05


def test_serving_worker_thread_bf16_autocast_and_no_grad(dev):
    """A request through ``DynamicBatcher`` runs its device calls on the
    worker thread: the convolutions in bfloat16 (the model's autocast,
    entered per call on that thread), no output requiring grad; the server
    reports the platform "gpu"."""
    from human_pose_tpu_torch.inference import DynamicBatcher
    from human_pose_tpu_torch.inference.serving import served_platform

    pred = _fixture_predictor(dev, torch.bfloat16)
    seen, decoded = [], []
    hooks = [m.register_forward_hook(lambda m, i, o: seen.append((o.dtype, o.requires_grad)))
             for m in pred.m.model.modules() if isinstance(m, torch.nn.Conv2d)]
    orig = pred.m.decode_masked
    pred.m.decode_masked = lambda *a, **kw: decoded.extend(orig(*a, **kw)) or decoded[-4:]
    batcher = DynamicBatcher(pred, max_batch=4, max_wait_ms=1.0)
    try:
        assert torch.is_grad_enabled()
        result = batcher.submit(_paint_fixture_image(0))
        assert served_platform(batcher) == "gpu"
    finally:
        batcher.close()
        for h in hooks:
            h.remove()
    assert result["num_people"] >= 1 and result["batch_size"] == 1
    assert seen and all(d == torch.bfloat16 and not g for d, g in seen)
    assert decoded and not any(t.requires_grad for t in decoded)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_export_program_round_trip_on_card(dev, dtype, tmp_path):
    """The fixture net exported on the card and loaded back: float32 within
    rel 1e-3 of the module's forward, bfloat16 (traced under autocast) at
    the level of decisions after the decode; the flat-weights npz into a
    new net on the card, strictly, bit for bit."""
    from human_pose_tpu_torch.inference import InferenceKeypointsModel
    from human_pose_tpu_torch.models import HigherHRNet
    from human_pose_tpu_torch.utils import export_program, export_weights_npz, load_flax_npz

    net = _fixture_net(dev)
    export_program(net, (3, 64, 64), tmp_path / "p.pt2", dtype=dtype)
    loaded = torch.export.load(str(tmp_path / "p.pt2")).module()
    im = InferenceKeypointsModel(net, input_size=64, dtype=dtype, device=dev)
    x = im.to_device(im.prepare_input(_paint_fixture_image(2))[0])
    with torch.no_grad():
        got_h, got_t = loaded(x)
        want_h, want_t = im._forward(x)
    for got, want in zip([*got_h, got_t], [*want_h, want_t]):
        assert got.dtype == torch.float32 and got.shape == want.shape
        if dtype == torch.float32:
            assert float((got - want).abs().max() / want.abs().max()) <= 1e-3
    if dtype == torch.bfloat16:
        kw = dict(max_num_people=10, det_thr=0.25, tag_thr=0.4)
        (gj, gs, gv), (wj, ws, wv) = [decode_batch(list(h), [t], (64, 64), **kw)
                                      for h, t in ((got_h, got_t), (want_h, want_t))]
        assert int(gv.sum()) == int(wv.sum()) >= 1
        assert float((gj[gv][..., :2] - wj[wv][..., :2]).abs().median()) < 0.5
        assert float((gs[gv].sort().values - ws[wv].sort().values).abs().max()) < 0.05
    export_weights_npz(net, tmp_path / "w.npz")
    again = HigherHRNet(num_kpts=17, C=8, device=dev)
    again.load_state_dict({k: torch.from_numpy(v) for k, v in load_flax_npz(tmp_path / "w.npz").items()},
                          strict=True)
    assert all(torch.equal(a, b) for a, b in zip(again.state_dict().values(), net.state_dict().values()))


# -- float32 repeatability on the card (the keypoints yaml's W32) ---------------

def test_serving_w32_float32_repeat_bit_equal_with_deterministic_cudnn(dev):
    """W32 from the keypoints yaml in float32 (seeded weights): one predict
    of a 480x640 request repeated three times is bit-equal, payload and
    forward maps, under cuDNN's deterministic algorithms with benchmark
    off. The same repeats under the yaml's cuDNN settings (benchmark on,
    deterministic off) and PyTorch's defaults are printed, not held: there
    cuDNN may pick algorithms that sum in a different order each call."""
    import chip_smoke
    from human_pose_tpu_torch.configs import KeypointsConfig
    from human_pose_tpu_torch.inference import BatchedKeypointsPredictor

    cfg = KeypointsConfig.from_dict(KeypointsConfig.from_yaml_to_dict(
        chip_smoke.EVAL_YAML, ["--inference.ckpt_path=null", "--trainer.accelerator=gpu"]))
    pred = BatchedKeypointsPredictor(cfg.create_inference_model())
    raw = np.random.default_rng(3).integers(0, 256, (480, 640, 3), dtype=np.uint8)
    readings = chip_smoke.repeat_readings(pred, pred.prepare(raw), chip_smoke.yaml_cudnn())
    for what, r in readings.items():
        print(what, {k: v for k, v in r.items() if k != "payload_gaps"},
              [(g["people_differ"], g["max_xy"], g["max_score"]) for g in r["payload_gaps"]])
    det = readings["deterministic"]
    assert det["forward_bit_equal"] and det["payload_bit_equal"]


# -- the model zoo (models/{resnet,simple_baseline,hourglass}.py, HRNetSPPE) ----

def _zoo_net(name, device):
    from human_pose_tpu_torch import models

    make = {
        "ae_hourglass": lambda: models.AEHourglassNet(17, 2, device=device),
        "hourglass": lambda: models.HourglassNet(16, 2, device=device),
        "simple_baseline": lambda: models.SimpleBaseline(17, "resnet50", device=device),
        "hrnet_sppe": lambda: models.HRNetSPPE(17, 32, device=device),
    }[name]
    return make().eval()


@pytest.mark.parametrize("name", ["ae_hourglass", "hourglass", "simple_baseline", "hrnet_sppe"])
def test_zoo_forward_card_equals_cpu(dev, name):
    """Each zoo net at full width, float32 (TF32 off), seeded with
    ``init_flax_default_``: the card's forward of a 64x128 image within rel
    1e-3 of the CPU's, every output float32."""
    from human_pose_tpu_torch.models import init_flax_default_

    net = init_flax_default_(_zoo_net(name, dev), torch.Generator().manual_seed(0))
    cpu = _zoo_net(name, "cpu")
    cpu.load_state_dict(net.state_dict())
    x = torch.from_numpy(np.random.RandomState(2).randn(2, 3, 64, 128).astype(np.float32))
    with torch.no_grad():
        got, want = net(x.to(dev)), cpu(x)
    flat = lambda o: [t for a in o for t in flat(a)] if isinstance(o, (list, tuple)) else [o]  # noqa: E731
    for g, w in zip(flat(got), flat(want), strict=True):
        assert g.dtype == torch.float32 and g.shape == w.shape
        assert float((g.cpu() - w).abs().max() / w.abs().max().clamp(min=1e-3)) <= 1e-3


def test_sppe_parse_card_equals_cpu(dev):
    """The single-person argmax on the card == on the CPU, ties included
    (the first row-major maximum)."""
    from human_pose_tpu_torch.ops import sppe_parse

    maps = torch.from_numpy(np.random.RandomState(5).rand(3, 17, 40, 30).astype(np.float32))
    maps[0, 0] = 0.5
    maps[1, 1, 7, :] = 2.0
    maps[2, 2, 3, 4] = maps[2, 2, 1, 9] = 2.0
    got = sppe_parse(maps.to(dev)).cpu()
    assert torch.equal(got, sppe_parse(maps))
    assert got[0, 0, 0, :2].tolist() == [0.0, 0.0] and got[1, 0, 1, :2].tolist() == [0.0, 7.0]
    assert got[2, 0, 2, :2].tolist() == [9.0, 1.0]


@pytest.mark.parametrize("compact", [False, True])
def test_sppe_inference_card_equals_cpu(dev, compact):
    """``InferenceSPPEModel`` on SimpleBaseline-R18 (seeded): the card's
    joints equal the CPU's on this seeded image, heatmaps within 1e-4 of
    their scale; no decode kernel launched."""
    from human_pose_tpu_torch.inference import InferenceSPPEModel
    from human_pose_tpu_torch.models import SimpleBaseline, init_flax_default_

    nets = {d: SimpleBaseline(17, "resnet18", device=d).eval() for d in (dev, "cpu")}
    init_flax_default_(nets[dev], torch.Generator().manual_seed(1))
    nets["cpu"].load_state_dict(nets[dev].state_dict())
    raw = np.random.RandomState(6).randint(0, 256, (200, 150, 3)).astype(np.uint8)
    before = (refine_argmax_batch.launches, match_by_tag_batched.launches)
    got, want = [InferenceSPPEModel(nets[d], input_size=128, compact_inputs=compact, device=d)(raw)
                 for d in (dev, "cpu")]
    assert (refine_argmax_batch.launches, match_by_tag_batched.launches) == before
    np.testing.assert_array_equal(got.kpts_coords, want.kpts_coords)
    scale = np.abs(want.kpts_heatmaps).max()
    assert np.abs(got.kpts_heatmaps - want.kpts_heatmaps).max() <= 1e-4 * scale


def test_ae_hourglass_inference_launches_each_kernel_once(dev):
    """``InferenceKeypointsModel`` on a one-stage AE hourglass (seeded) at
    128 with flip: one launch of the dense refine and of the grouping a
    call, and the card's decode equal to the CPU's plain decode of the
    card's own aggregated maps (joints within 1e-3, as chip_smoke's phase
    6)."""
    from human_pose_tpu_torch.inference import InferenceKeypointsModel
    from human_pose_tpu_torch.models import AEHourglassNet, init_flax_default_

    net = init_flax_default_(AEHourglassNet(17, 1, device=dev), torch.Generator().manual_seed(2)).eval()
    kw = dict(det_thr=0.05, tag_thr=0.5, use_flip=True, input_size=128, max_num_people=10)
    im, im_cpu = (InferenceKeypointsModel(n, **kw, device=d)
                  for n, d in ((net, dev), (copy.deepcopy(net).cpu(), "cpu")))
    x, _, _ = im.prepare_input(np.random.RandomState(7).randint(0, 256, (150, 200, 3)).astype(np.uint8))
    hw = x.shape[1:3]
    before = (refine_argmax_batch.launches, match_by_tag_batched.launches)
    avg, tags_list = im.forward_scale(im.to_device(x), hw)
    joints, scores, valid, _ = im.decode_masked(avg, tags_list, hw, 1.0)
    torch.cuda.synchronize()
    assert (refine_argmax_batch.launches - before[0], match_by_tag_batched.launches - before[1]) == (1, 1)
    cj, cs, cv, _ = im_cpu.decode_masked(avg.cpu(), [t.cpu() for t in tags_list], hw, 1.0)
    assert torch.equal(valid.cpu(), cv) and int(cv.sum()) >= 1
    # the kernels equal their plain versions; the rest of the decode as phase 6 holds it
    assert float((joints.cpu()[cv][..., :3] - cj[cv][..., :3]).abs().max()) <= 1e-3


# -- zoo and data-parallel training --------------------------------------------------------

def test_ae_hourglass_step_reduced_card_equals_cpu(dev):
    """One float32 Adam step of the one-stage full-width AE hourglass (batch
    2 at 128^2) on the card and on the CPU from the same weights and batch:
    ``chip_smoke``'s phase 15 check and its tolerances (loss terms rel
    1e-4, each device's gradients within 1e-3 of float64 evaluated with its
    own ReLU decisions, BN statistics, parameters after the step)."""
    import chip_smoke

    out = chip_smoke.ae_hourglass_step_card_vs_cpu(dev)
    assert out["loss_rel"] <= 1e-4 and out["grad_rel_max"] <= 1e-3 and out["no_grad_params"] == 4


def test_world_size_one_nccl_step_bit_equal(dev):
    """An NCCL process group of one, joined from torchrun's environment
    (``chip_smoke.process_group_of_one``): two keypoints steps of the
    one-stage AE hourglass through the mesh (gradients, BatchNorm
    statistics and metrics all-reduced, the initial state broadcast) equal
    two steps without a mesh, bit for bit: metrics, parameters and buffers
    (float32, cuDNN deterministic, no autotuning)."""
    import torch.distributed as dist

    from human_pose_tpu_torch.models import AEHourglassNet, init_keypoints_weights_
    from human_pose_tpu_torch.parallel import replicate_global
    from human_pose_tpu_torch.train import TrainState, create_optimizer, keypoints_train_step

    import chip_smoke

    cudnn = torch.backends.cudnn
    saved = (cudnn.benchmark, cudnn.deterministic)
    cudnn.benchmark, cudnn.deterministic = False, True
    try:
        with chip_smoke.process_group_of_one() as mesh:
            assert dist.get_backend() == "nccl" and mesh.world_size == 1 and mesh.device == dev
            net = init_keypoints_weights_(AEHourglassNet(17, 1, device=dev), torch.Generator().manual_seed(4))
            batch = chip_smoke.train_batch(2, 128, 10, torch.Generator(device=dev).manual_seed(4), dev,
                                           strides=(4,))
            runs = []
            for m in (None, mesh):
                model = copy.deepcopy(net)
                if m is not None:
                    replicate_global(m, model)
                state = TrainState.create(model, create_optimizer(model.parameters(), "Adam", 1e-3),
                                          device=dev, mesh=m)
                metrics = [{k: float(v) for k, v in keypoints_train_step(state, batch, 1e-3)[1].items()}
                           for _ in range(2)]
                runs.append((metrics, {k: v.cpu() for k, v in model.state_dict().items()}))
    finally:
        cudnn.benchmark, cudnn.deterministic = saved
    assert not dist.is_initialized()
    (m_plain, sd_plain), (m_mesh, sd_mesh) = runs
    assert m_plain == m_mesh
    assert all(torch.equal(v, sd_mesh[k]) for k, v in sd_plain.items())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sync_batch_norm_in_nccl_group_of_one(dev, dtype):
    """``SyncBatchNorm2d`` in an NCCL group of one (its moments and its
    backward's sums all-reduced on the card) against ``BatchNorm2d`` on the
    same input: the output and the input's gradient within 1e-5 and 1e-4
    of their scale in float32 (2**-7 in bfloat16: ``BatchNorm2d`` rounds
    its bf16 gradient, ``SyncBatchNorm2d`` computes it in float32), the
    parameters' float32 gradients within 1e-4, the running statistics
    within 1e-6."""
    from human_pose_tpu_torch.models.norm import BatchNorm2d, SyncBatchNorm2d

    import chip_smoke

    g = torch.Generator(device=dev).manual_seed(6)
    x = (torch.randn(4, 8, 16, 16, generator=g, device=dev) * 2 + 1).to(dtype)
    r = torch.randn(4, 8, 16, 16, generator=g, device=dev)
    outs = []
    with chip_smoke.process_group_of_one():
        for cls in (BatchNorm2d, SyncBatchNorm2d):
            bn = cls(8).to(dev).train()
            xi = x.clone().requires_grad_(True)
            y = bn(xi)
            (y.float() * r).sum().backward()
            outs.append((y.float(), xi.grad.float(), bn.weight.grad, bn.bias.grad, bn.running_mean,
                         bn.running_var))
    (y0, gx0, gw0, gb0, m0, v0), (y1, gx1, gw1, gb1, m1, v1) = outs
    tol = 1e-5 if dtype == torch.float32 else 2 ** -7
    assert float((y1 - y0).abs().max()) <= tol * float(y0.abs().max())
    assert float((gx1 - gx0).abs().max()) <= max(tol, 1e-4) * float(gx0.abs().max())
    for a, b in ((gw1, gw0), (gb1, gb0)):
        assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max())
    assert gw1.dtype == gb1.dtype == torch.float32
    assert float((m1 - m0).abs().max()) <= 1e-6 and float((v1 - v0).abs().max()) <= 1e-6 * float(v0.max())


def test_ae_hourglass_make_results_launches_each_kernel_once(dev):
    """``KeypointsModule.make_results`` on the two-stage AE hourglass's
    validation outputs (two 1/4 stages and the last stage's tags, seeded
    weights): one launch of the dense refine and of the grouping, at the
    val thresholds (det 0.1, tag 1.0), each equal to its plain version on
    those inputs; a result an image with finite joints."""
    import chip_smoke
    from human_pose_tpu_torch.models import AEHourglassNet, init_flax_default_
    from human_pose_tpu_torch.train import DeviceBatch, KeypointsModule

    module = KeypointsModule.create(AEHourglassNet(17, 2, device=dev))
    init_flax_default_(module.model, torch.Generator().manual_seed(5))
    batch = DeviceBatch(chip_smoke.train_batch(2, 128, 10, torch.Generator(device=dev).manual_seed(5), dev,
                                               strides=(4, 4)))
    _, outputs = module.validation_step(batch)
    assert [tuple(h.shape) for h in outputs[0]] == [(2, 17, 32, 32)] * 2
    before = (refine_argmax_batch.launches, match_by_tag_batched.launches)
    seen = chip_smoke.record_kernel_inputs(lambda: module.make_results(batch, outputs))
    torch.cuda.synchronize()
    assert (refine_argmax_batch.launches - before[0], match_by_tag_batched.launches - before[1]) == (1, 1)
    hm, tg, prev, cnt = seen["refine_argmax"]
    cand, det_thr, tag_thr, order, persons = seen["match_by_tag"]
    assert (det_thr, tag_thr) == (0.1, 1.0)
    assert torch.equal(refine_argmax_batch(hm, tg, prev, cnt).cpu(),
                       refine_argmax_batch_plain(hm.cpu(), tg.cpu(), prev.cpu(), cnt.cpu()))
    got = match_by_tag_batched(cand, det_thr, tag_thr, order, persons)
    want = match_by_tag_batched_plain(cand.cpu(), det_thr, tag_thr, order, persons)
    assert all(torch.equal(a.cpu(), b) for a, b in zip(got, want))
    results = module.make_results(batch, outputs)
    assert len(results) == 2 and all(np.isfinite(r.kpts_coords).all() for r in results)


def test_sharded_evaluator_nccl_group_of_one_equals_one_process(fixture_eval, dev):
    """``BatchedKeypointsEvaluator(mesh=...)`` in an NCCL process group of
    one (``chip_smoke.process_group_of_one``), each image added with its
    dataset index and the records gathered through NCCL: the detections
    equal the one-process evaluator's image by image, bit for bit (cuDNN
    deterministic, no autotuning), in dataset order, with as many launches
    of the dense refine and the grouping (one a batch)."""
    from human_pose_tpu_torch.inference import BatchedKeypointsEvaluator, image_id_from_path

    import chip_smoke

    ds, model = fixture_eval
    im = model(dev)
    cudnn = torch.backends.cudnn
    saved = (cudnn.benchmark, cudnn.deterministic)
    cudnn.benchmark, cudnn.deterministic = False, True
    try:
        refine_argmax_batch.launches = match_by_tag_batched.launches = 0
        one, one_dets = _batched(im, ds, 4)
        one_launches = (refine_argmax_batch.launches, match_by_tag_batched.launches)
        with chip_smoke.process_group_of_one() as mesh:
            refine_argmax_batch.launches = match_by_tag_batched.launches = 0
            ev = BatchedKeypointsEvaluator(im, batch_size=4, mesh=mesh)
            for i in ev.shard(len(ds)):
                ev.add(ds.load_image(i), image_id_from_path(ds.images_filepaths[i], i),
                       ds.load_annot(i), index=i)
            dets, oks = ev.finish()
            launches = (refine_argmax_batch.launches, match_by_tag_batched.launches)
    finally:
        cudnn.benchmark, cudnn.deterministic = saved
    assert launches == one_launches == (one.n_batches, one.n_batches) and ev.n_batches == one.n_batches
    ids = [d["image_id"] for d in dets]
    assert ids == sorted(ids) and len(set(ids)) == len(ds)

    def by_image(d):
        out = {}
        for x in d:
            out.setdefault(x["image_id"], []).append(x)
        return out

    assert by_image(dets) == by_image(one_dets) and len(oks) == len(ds)


def test_checkpoint_directory_on_card(dev, tmp_path):
    """The directory backend (``train/checkpoint_orbax.py``) on the card: a
    state after a step saved synchronously loads back into a card module
    and a CPU module bit for bit; a ``use_async`` save holds the state of
    its call although two more steps updated it in place before the write
    was waited for."""
    from human_pose_tpu_torch.models import HigherHRNet
    from human_pose_tpu_torch.train import KeypointsModule, checkpoint_orbax

    module = KeypointsModule.create(HigherHRNet(**_REDUCED, device=dev), seed=2)
    module.training_step(_host_batch(5, compact=True, n=4, size=128))
    model_sd, opt_state = _clone_state(module)
    checkpoint_orbax.save_checkpoint(tmp_path / "sync", module.state, epoch=3)
    fut = checkpoint_orbax.save_checkpoint(tmp_path / "async", module.state, epoch=3, use_async=True)
    module.training_step(_host_batch(6, compact=True, n=4, size=128))
    module.training_step(_host_batch(7, compact=True, n=4, size=128))
    fut.result(timeout=120)
    for name in ("sync", "async"):
        for device in (dev, "cpu"):
            other = KeypointsModule.create(HigherHRNet(**_REDUCED, device=device), seed=9)
            checkpoint_orbax.load_train_state(other.state,
                                              checkpoint_orbax.load_checkpoint(tmp_path / name))
            assert other.state.step == 1
            for k, v in other.model.state_dict().items():
                assert torch.equal(v.cpu(), model_sd[k].cpu()), (name, device, k)
            got = other.state.optimizer.state_dict()["state"]
            for i, s in opt_state.items():
                for k, v in s.items():
                    assert torch.equal(got[i][k].cpu(), v.cpu()) if torch.is_tensor(v) else got[i][k] == v


def test_gpu_info_monitor_on_card(dev, tmp_path):
    """``GpuInfoMonitor``'s sample: a line for the card in
    ``TpuInfoMonitor``'s format whose in-use and peak GB are
    ``memory_allocated``'s and ``max_memory_allocated``'s and whose limit
    is ``mem_get_info``'s total; started, it writes its file."""
    import re
    import time

    from human_pose_tpu_torch.loggers import GpuInfoMonitor

    x = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device=dev)  # 0.27 GB held
    mon = GpuInfoMonitor(str(tmp_path / "gpu.log"), interval_s=0.05)
    lines = mon.sample().splitlines()
    assert len(lines) == 1 + torch.cuda.device_count()
    m = re.fullmatch(r"  (.+) #0: ([\d.]+)/([\d.]+) GB \(peak ([\d.]+) GB\)", lines[1])
    assert m and m.group(1) == torch.cuda.get_device_name(0), lines[1]
    in_use, limit, peak = (float(m.group(i)) for i in (2, 3, 4))
    assert in_use == round(torch.cuda.memory_allocated(0) / 1e9, 2) and in_use >= 0.26
    assert peak == round(torch.cuda.max_memory_allocated(0) / 1e9, 2)
    assert limit == round(torch.cuda.mem_get_info(0)[1] / 1e9, 2)
    mon.start()
    time.sleep(0.5)
    mon.stop()
    assert (tmp_path / "gpu.log").read_text().splitlines()[1] == lines[1]
    del x


# -- model parallelism on one card ---------------------------------------------------------

def _w32(dev):
    from human_pose_tpu_torch.models import HigherHRNet, init_flax_default_

    return init_flax_default_(HigherHRNet(num_kpts=17, C=32, device=dev),
                              torch.Generator().manual_seed(17)).eval()


def test_pipeline_w32_four_segments_on_one_card(dev):
    """``PipelinedModel`` of W32 with ``DEFAULT_PARTITION`` and ``cuda:0``
    as each segment's device, two microbatches of two at 256^2, float32:
    every output within 1e-4 of the monolithic forward's scale (random
    W32's heatmaps reach the thousands, where float32's spacing is 2.4e-4;
    cuDNN picks other algorithms at batch 2)."""
    from human_pose_tpu_torch.parallel import DEFAULT_PARTITION, PipelinedModel

    net = _w32(dev)
    x = torch.randn((4, 3, 256, 256), generator=torch.Generator(device=dev).manual_seed(17), device=dev)
    pipe = PipelinedModel(net, DEFAULT_PARTITION, [dev] * 4)
    assert len(pipe.segments) == 4 and all(d == dev for _, d in pipe.segments)
    hms, tags = pipe(x, microbatch_size=2)
    with torch.no_grad():
        want_hms, want_tags = net(x)
    for got, want in zip([*hms, tags], [*want_hms, want_tags]):
        assert got.device == dev and got.dtype == torch.float32
        assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())


def test_pipelined_predictor_launches_each_decode_kernel_once(dev):
    """``InferenceKeypointsModel(pipeline_devices=1)`` with flip behind
    ``BatchedKeypointsPredictor``: a predict of three requests launches the
    dense refine and the grouping once each, and its payloads equal those
    of ``pipeline_devices=0`` (cuDNN deterministic)."""
    from human_pose_tpu_torch.inference import InferenceKeypointsModel
    from human_pose_tpu_torch.inference.serving import BatchedKeypointsPredictor
    from human_pose_tpu_torch.ops import cuda_decode, cuda_match

    net = _w32(dev)
    rng = np.random.default_rng(17)
    raws = [rng.integers(0, 256, (240, 320, 3), dtype=np.uint8) for _ in range(3)]
    kw = dict(use_flip=True, input_size=256, det_thr=0.05, tag_thr=0.5)
    cudnn = torch.backends.cudnn
    saved = (cudnn.benchmark, cudnn.deterministic)
    cudnn.benchmark, cudnn.deterministic = False, True
    try:
        out = {}
        for n in (0, 1):
            pred = BatchedKeypointsPredictor(InferenceKeypointsModel(net, pipeline_devices=n, device=dev, **kw))
            reqs = [pred.prepare(raw) for raw in raws]
            cuda_decode.refine_argmax_batch.launches = cuda_match.match_by_tag_batched.launches = 0
            out[n] = pred.predict(reqs)
            torch.cuda.synchronize()
            assert (cuda_decode.refine_argmax_batch.launches, cuda_match.match_by_tag_batched.launches) == (1, 1)
    finally:
        cudnn.benchmark, cudnn.deterministic = saved
    assert out[1] == out[0]


def test_mesh_of_one_nccl_step_bit_equal(dev):
    """One float32 Adam step of W32 (batch 2 at 128^2) on the (1, 1) and
    (1, 1, 1) meshes of an NCCL group of one (``chip_smoke``'s phase 17
    check) equals the step without a mesh bit for bit: metrics, parameters
    and buffers (cuDNN deterministic)."""
    import torch.distributed as dist

    from human_pose_tpu_torch.parallel import (
        make_mesh_2d, make_mesh_3d, shard_batch_spatial, shard_state_tensor,
    )
    from human_pose_tpu_torch.train import TrainState, create_optimizer, keypoints_train_step

    import chip_smoke

    net = _w32(dev)
    batch = chip_smoke.train_batch(2, 128, 10, torch.Generator(device=dev).manual_seed(17), dev)
    cudnn = torch.backends.cudnn
    saved = (cudnn.benchmark, cudnn.deterministic)
    cudnn.benchmark, cudnn.deterministic = False, True
    runs = []
    try:
        with chip_smoke.process_group_of_one():
            assert dist.get_backend() == "nccl"
            for mesh in (None, make_mesh_2d(1, 1), make_mesh_3d(1, 1, 1)):
                model = copy.deepcopy(net)
                if mesh is not None:
                    assert mesh.device == dev
                    shard_state_tensor(mesh, model)
                state = TrainState.create(model, create_optimizer(model.parameters(), "Adam", 1e-3),
                                          device=dev, mesh=mesh)
                part = batch if mesh is None else shard_batch_spatial(mesh, batch)
                metrics = keypoints_train_step(state, part, 1e-3)[1]
                runs.append(({k: float(v) for k, v in metrics.items()},
                             {k: v.cpu() for k, v in model.state_dict().items()}))
    finally:
        cudnn.benchmark, cudnn.deterministic = saved
    assert not dist.is_initialized()
    (m_plain, sd_plain), *meshes = runs
    for m_mesh, sd_mesh in meshes:
        assert m_mesh == m_plain
        assert sd_mesh.keys() == sd_plain.keys()
        assert all(torch.equal(v, sd_mesh[k]) for k, v in sd_plain.items())


# -- the benchmark CLIs ---------------------------------------------------------------------

@pytest.mark.parametrize("stage", ["decode_sparse", "decode_noise"])
def test_bench_decode_kernels_equal_plain_at_512(dev, stage):
    """``bench_decompose``'s maps for one image at 512^2 (GT-like sparse
    peaks; uniform noise, where all 30 candidates of every joint clear
    det_thr): one launch each of the dense refine and the grouping, and each
    kernel's outputs on that call's inputs equal to its plain version's."""
    import chip_smoke
    from human_pose_tpu_torch.bin import bench_decompose

    maps = bench_decompose.bench_maps(1, 512, dev)[stage]
    before = (refine_argmax_batch.launches, match_by_tag_batched.launches)
    out = []
    seen = chip_smoke.record_kernel_inputs(lambda: out.append(bench_decompose.decode_maps(*maps, 512)))
    torch.cuda.synchronize()
    assert (refine_argmax_batch.launches - before[0], match_by_tag_batched.launches - before[1]) == (1, 1)
    joints, _, valid = out[0]
    assert bool(torch.isfinite(joints).all()) and int(valid.sum()) >= 1
    hm, tg, prev, cnt = seen["refine_argmax"]
    assert torch.equal(refine_argmax_batch(hm, tg, prev, cnt), refine_argmax_batch_plain(hm, tg, prev, cnt))
    cand, det_thr, tag_thr, order, persons = seen["match_by_tag"]
    if stage == "decode_noise":
        assert int((cand[..., 2] > det_thr).sum()) == cand.shape[1] * cand.shape[2]
    got = match_by_tag_batched(cand, det_thr, tag_thr, order, persons)
    want = match_by_tag_batched_plain(cand, det_thr, tag_thr, order, persons)
    assert all(torch.equal(a, b) for a, b in zip(got, want)) and int(got[1].max()) <= persons


def test_remat_step_equals_plain_step_on_card(dev):
    """A bfloat16 Adam step of HigherHRNet C=8 with ``remat=(0, 4)`` on
    ``bench_train``'s synthesized batch (2 at 128^2) equals the step without
    remat bit for bit under cuDNN deterministic: metrics, parameters and
    BatchNorm statistics (the recompute leaves them to move once)."""
    from human_pose_tpu_torch.bin import bench_train
    from human_pose_tpu_torch.models import HigherHRNet, init_flax_default_
    from human_pose_tpu_torch.train import TrainState, create_optimizer, keypoints_train_step

    cudnn = torch.backends.cudnn
    saved = (cudnn.benchmark, cudnn.deterministic)
    cudnn.benchmark, cudnn.deterministic = False, True
    runs = []
    try:
        for remat in (False, (0, 4)):
            model = HigherHRNet(num_kpts=17, C=8, remat=remat, device=dev)
            init_flax_default_(model, torch.Generator().manual_seed(0))
            state = TrainState.create(model, create_optimizer(model.parameters(), "Adam", 1e-3),
                                      dtype=torch.bfloat16, device=dev)
            metrics = keypoints_train_step(state, bench_train.synth_batch(0, 2, 128, dev), 1e-3)[1]
            runs.append(({k: float(v) for k, v in metrics.items()},
                         {k: v.cpu() for k, v in model.state_dict().items()}))
    finally:
        cudnn.benchmark, cudnn.deterministic = saved
    (m_plain, sd_plain), (m_remat, sd_remat) = runs
    assert m_remat == m_plain and all(np.isfinite(v) for v in m_plain.values())
    assert all(torch.equal(v, sd_remat[k]) for k, v in sd_plain.items())


def test_bench_train_classification_on_card(dev, capsys):
    """``bin.bench_train --task=classification`` (W32, SGD nesterov) at a
    small batch on the card: one finite record on the gpu platform."""
    from human_pose_tpu_torch.bin import bench_train

    rec = bench_train.main(["--task=classification", "--batch=8", "--size=64", "--iters=2"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == rec
    assert rec["metric"] == "train images/sec ClassificationHRNet-W32 @64 (bs 8, 1 devices)"
    assert rec["platform"] == "gpu" and all(np.isfinite(rec[k]) and rec[k] > 0
                                            for k in ("value", "ms_per_step", "loss"))


def test_bench_decompose_cli_on_card(dev, capsys):
    """``bin.bench_decompose`` at a small size on the card: its four records
    in order, each with the stream's ms between two CUDA events, finite."""
    from human_pose_tpu_torch.bin import bench_decompose

    recs = bench_decompose.main(["--batch=2", "--iters=2", "--size=128"])
    assert [json.loads(line) for line in capsys.readouterr().out.strip().splitlines()] == recs
    assert [r["stage"] for r in recs] == list(bench_decompose.STAGES)
    assert all(r["platform"] == "gpu" and np.isfinite(r["stream_ms_per_img"]) and r["ms_per_img"] > 0
               for r in recs)


# -- no hidden waits on the benchmark cells' paths -----------------------------------------

def _no_sync_paths(dev) -> dict:
    """The program paths the benchmark cells run, as functions of nothing on
    device inputs: ``forward_scale`` + ``decode_masked`` of a bfloat16
    HigherHRNet-W32 (plain, and with the flip test), one keypoints and one
    classification train step (bfloat16; Adam, SGD Nesterov) on device
    batches of uint8 images."""
    from human_pose_tpu_torch.inference import InferenceKeypointsModel
    from human_pose_tpu_torch.models import ClassificationHRNet, HigherHRNet
    from human_pose_tpu_torch.train import (
        TrainState, classification_train_step, create_optimizer, keypoints_train_step,
    )

    torch.manual_seed(0)
    gen = torch.Generator(device=dev).manual_seed(1)
    n, k, p, s = 2, 17, 30, 256
    net = HigherHRNet(num_kpts=k, C=32, device=dev).eval()
    frames = torch.randint(0, 256, (n, 3, s, s), dtype=torch.uint8, generator=gen, device=dev)
    paths = {}
    for flip in (False, True):
        model = InferenceKeypointsModel(net, use_flip=flip, compact_inputs=True,
                                        max_num_people=p, dtype=torch.bfloat16, device=dev)

        def infer(model=model):
            avg, tags = model.forward_scale(frames, (s, s))
            return model.decode_masked(avg, tags, (s, s), 1.0)

        paths[f"infer_flip{int(flip)}"] = infer
    kp_net = HigherHRNet(num_kpts=k, C=32, device=dev)
    kp_state = TrainState.create(kp_net, create_optimizer(kp_net.parameters(), "Adam", 1e-3),
                                 dtype=torch.bfloat16, device=dev)
    xy = torch.randint(0, s // 4, (n, p, k, 2), dtype=torch.int32, generator=gen, device=dev)
    vis = torch.randint(0, 2, (n, p, k, 1), dtype=torch.int32, generator=gen, device=dev)
    kp_batch = {
        "images": frames,
        "heatmaps": [torch.rand(n, k, s // 4, s // 4, generator=gen, device=dev),
                     torch.rand(n, k, s // 2, s // 2, generator=gen, device=dev)],
        "masks": [torch.ones(n, s // 4, s // 4, device=dev), torch.ones(n, s // 2, s // 2, device=dev)],
        "joints": torch.cat([xy, vis], -1),
    }
    paths["keypoints_train_step"] = lambda: keypoints_train_step(kp_state, kp_batch, 1e-3)
    cls_net = ClassificationHRNet(C=32, device=dev)
    cls_state = TrainState.create(
        cls_net, create_optimizer(cls_net.parameters(), "SGD", 0.1, momentum=0.9, nesterov=True),
        dtype=torch.bfloat16, device=dev)
    images = torch.randint(0, 256, (n, 3, 224, 224), dtype=torch.uint8, generator=gen, device=dev)
    labels = torch.randint(0, 1000, (n,), generator=gen, device=dev)
    paths["classification_train_step"] = lambda: classification_train_step(cls_state, images, labels, 0.1)
    return paths


@pytest.mark.parametrize("path", ["infer_flip0", "infer_flip1", "keypoints_train_step",
                                  "classification_train_step"])
def test_cells_paths_make_no_host_sync(dev, path):
    """Each path of ``_no_sync_paths`` once more after a warm-up (the
    kernels' builds, the per-device constants), under
    ``torch.cuda.set_sync_debug_mode("error")``: a synchronizing CUDA call
    (a pageable host->device copy, ``.item()``, ``nonzero``, a synchronize)
    inside it raises. The paths' results stay on the card."""
    fn = _no_sync_paths(dev)[path]
    fn()
    torch.cuda.synchronize(dev)
    torch.cuda.set_sync_debug_mode("error")
    try:
        fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize(dev)
