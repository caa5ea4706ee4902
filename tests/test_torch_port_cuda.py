"""The port's CUDA kernels vs their plain versions, on the card.

Marked ``cuda``: each test skips where no card is present (decided in the
fixture, never at import). The file imports neither JAX nor the JAX package,
so it runs on a machine without them:

    python -m pytest -o addopts="" --noconftest -m cuda tests/test_torch_port_cuda.py

The kernels repeat their plain versions' float32 arithmetic step for step,
so every comparison is exact.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from human_pose_tpu_torch.ops import (
    JOINTS_ORDER, decode_batch, match_by_tag_batched, match_by_tag_batched_plain,
    refine_argmax_batch, refine_argmax_batch_plain,
)

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
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


@pytest.mark.parametrize("e", [1, 2, 3])
def test_refine_kernel_equals_plain(dev, e):
    rng = np.random.RandomState(e)
    b, k, hw, p = 4, 5, 96 * 160, 30
    hm = torch.from_numpy(rng.rand(b, k, hw).astype(np.float32)).to(dev)
    tags = torch.from_numpy(rng.randn(b, k, e, hw).astype(np.float32) * 2).to(dev)
    prev = torch.from_numpy(rng.randn(b, p, e).astype(np.float32) * 2).to(dev)
    counts = torch.tensor([30, 0, 1, 17], dtype=torch.int32, device=dev)
    want = refine_argmax_batch_plain(hm, tags, prev, counts)
    got = refine_argmax_batch(hm, tags, prev, counts)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def test_refine_kernel_tie_first(dev):
    hm = torch.ones((2, 3, 4096), device=dev)
    tags = torch.zeros((2, 3, 1, 4096), device=dev)
    prev = torch.zeros((2, 8, 1), device=dev)
    counts = torch.tensor([8, 2], dtype=torch.int32, device=dev)
    assert int(refine_argmax_batch(hm, tags, prev, counts).abs().max()) == 0


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
