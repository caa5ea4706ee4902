"""The port's CUDA kernels vs their plain versions, on the card.

Marked ``cuda``: each test skips where no card is present (decided in the
fixture, never at import). The file imports neither JAX nor the JAX package,
so it runs on a machine without them:

    python -m pytest -o addopts="" --noconftest -m cuda tests/test_torch_port_cuda.py

The decode kernels repeat their plain versions' float32 arithmetic step for
step, so those comparisons are exact. The fused BasicBlock sums its
convolutions in another order than cuDNN: float32 within 1e-4 (TF32 off),
bfloat16 (bf16 operands on the tensor cores) within 2**-6 of the output's
scale, a few bf16 ulps: an intermediate value at a bf16 rounding boundary
can round either way.
"""

from __future__ import annotations

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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [
    (2, 32, 32, 32), (2, 16, 16, 64), (1, 8, 12, 128), (2, 8, 8, 256), (1, 5, 7, 12),
    # the four W32 branch shapes, and H, W off the tile grid with C = 12, 48 (padded to 16, 64)
    (2, 128, 128, 32), (2, 64, 64, 64), (2, 32, 32, 128), (2, 16, 16, 256),
    (2, 19, 9, 12), (1, 21, 37, 48), (1, 9, 23, 128), (1, 13, 11, 256),
])
def test_fused_basic_block_kernel_vs_plain(dev, shape, dtype):
    """float32 on CUDA cores, bfloat16 on the tensor cores (against the
    plain version on bf16-rounded weights); for bfloat16 a second call on
    weights packed once gives the same bits."""
    from human_pose_tpu_torch.ops.cuda_conv import fused_basic_block_packed, pack_block_weights

    rng = np.random.RandomState(shape[-1])
    c = shape[-1]
    x = torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(dev, dtype)
    w1, w2 = (rng.randn(3, 3, c, c).astype(np.float32) / np.sqrt(9 * c) for _ in range(2))
    b1, b2 = (rng.randn(c).astype(np.float32) * 0.1 for _ in range(2))
    ws = [torch.from_numpy(a).to(dev) for a in (w1, b1, w2, b2)]
    want = fused_basic_block_plain(x, *ws).float()
    before = fused_basic_block.launches
    got = fused_basic_block(x, *ws)
    torch.cuda.synchronize()
    assert fused_basic_block.launches == before + 1
    assert got.dtype == dtype and got.shape == x.shape
    err = float((got.float() - want).abs().max())
    tol = 1e-4 if dtype == torch.float32 else 2 ** -6 * float(want.abs().max())
    assert err <= tol, (err, tol)
    if dtype == torch.bfloat16:
        assert torch.equal(fused_basic_block_packed(x, *pack_block_weights(*ws)), got)


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
