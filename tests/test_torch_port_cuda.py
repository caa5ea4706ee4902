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

    gen = torch.Generator().manual_seed(11)
    x = (torch.randn((6, 32, 24, 20), generator=gen) * (0.1 + 3 * torch.rand((1, 32, 1, 1), generator=gen))
         + torch.randn((1, 32, 1, 1), generator=gen)).to(dtype)
    gy = torch.randn(x.shape, generator=gen).to(dtype)
    w, b = torch.linspace(0.5, 1.5, 32), torch.linspace(-0.2, 0.2, 32)
    stats, outs = [], None
    for where in ("cpu", dev):
        m = batch_norm(32).to(where).train()
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

    x64, gy64, c = x.double(), gy.double(), (None, slice(None), None, None)
    mean = x64.mean((0, 2, 3))
    xhat = (x64 - mean[c]) / (x64.var((0, 2, 3), unbiased=False) + 1e-5).sqrt()[c]
    grad_w = (gy64 * xhat).sum((0, 2, 3))
    grad_b = gy64.sum((0, 2, 3))
    n = x64.numel() / 32
    grad_x = (w.double() / (x64.var((0, 2, 3), unbiased=False) + 1e-5).sqrt())[c] * (
        gy64 - (grad_b / n)[c] - xhat * (grad_w / n)[c])
    want = [xhat * w.double()[c] + b.double()[c], grad_x, grad_w, grad_b]
    for i, (got, ref) in enumerate(zip(outs, want)):
        tol = 2 ** -7 if dtype == torch.bfloat16 and i < 2 else 1e-4
        err = float((got - ref).abs().max()) / float(ref.abs().max())
        assert err <= tol, (i, err)


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
