"""Plain associative-embedding decode of one image, the benchmark's reference
for the program's batched decode.

The published decode (HigherHRNet's ``HeatmapParser``, after Newell et al.,
"Associative Embedding", NeurIPS 2017): 5x5 max-pool NMS, the top M
candidates of each joint (ties to the lowest flat index), grouping joint by
joint in the COCO order with the cost ``round(dist) * 100 - score`` solved
as an assignment (columns of persons not yet made, and the square's
padding, cost ``|largest real cost| * 2 + 100``), a match kept only below
``tag_thr``, every other candidate above ``det_thr`` a new person (at most
M), a one-person fallback when nothing groups, the quarter-pixel adjust and
the refine that fills each detected person's missing joints by
``argmax(heatmap - round(tag distance))``.

The arithmetic is float32 throughout, in the order the published code
implies (tag distances: squares summed from dim 0 and a square root, ``|d|``
in the refine's single-dim case, which rounds alike; person tags: sums in
order of insertion over the count). The assignment is the shortest-
augmenting-path Hungarian (Jonker-Volgenant potentials) in float32, valid
rows assigned one by one in candidate order, an argmin's ties to the lowest
column. At tags of some thousands float32 potentials can stop short of the
float64 optimum that SciPy's or Munkres' solver finds; this solver's
answers are the ones the program is specified to give (the JAX package's
``ops/hungarian.py``). The maps and the candidate selection run as plain
``torch`` ops on the maps' device, the assignment in NumPy on the host.
Nothing of the program is imported.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

# the COCO grouping order (HigherHRNet's grouping.py), 0-based
JOINTS_ORDER = tuple(i - 1 for i in [1, 2, 3, 4, 5, 6, 7, 12, 13, 8, 9, 10, 11, 14, 15, 16, 17])


def candidates(hm: torch.Tensor, tags: torch.Tensor, m: int) -> np.ndarray:
    """``hm [K, H, W]``, ``tags [K, E, H, W]`` -> ``[K, M, 3+E]`` float32 rows
    (x, y, score, tags) of each joint's M best NMS peaks, best first."""
    k, h, w = hm.shape
    e = tags.shape[1]
    pooled = F.max_pool2d(hm[None], 5, 1, 2)[0]
    sup = torch.where(pooled == hm, hm, torch.zeros((), dtype=hm.dtype, device=hm.device))
    vals, idx = torch.sort(sup.reshape(k, -1), dim=1, descending=True, stable=True)
    vals, idx = vals[:, :m], idx[:, :m]
    t = tags.reshape(k, e, -1).gather(2, idx[:, None, :].expand(k, e, m)).transpose(1, 2)
    xy = torch.stack([idx % w, idx // w], -1).to(torch.float32)
    return torch.cat([xy, vals[..., None], t], -1).cpu().numpy()


INF = np.float32(1e18)


def hungarian(cost: np.ndarray, rows: int) -> np.ndarray:
    """Min-cost assignment of the first ``rows`` rows of the square float32
    ``cost``: the column of each row, -1 for the rest."""
    n = cost.shape[0]
    u = np.zeros(n + 1, np.float32)
    v = np.zeros(n + 1, np.float32)
    owner = [0] * (n + 1)  # owner[j]: row (1-based) holding column j
    for i in range(1, rows + 1):
        owner[0] = i
        minv = np.full(n + 1, INF, np.float32)
        used = np.zeros(n + 1, bool)
        way = [0] * (n + 1)
        j0 = 0
        while owner[j0] != 0:
            used[j0] = True
            i0 = owner[j0]
            cur = np.concatenate([[INF], cost[i0 - 1] - u[i0] - v[1:]]).astype(np.float32)
            upd = ~used & (cur < minv)
            for j in np.flatnonzero(upd):
                way[j] = j0
            minv = np.where(upd, cur, minv)
            masked = np.where(used, INF, minv)
            masked[0] = INF
            j1 = int(np.argmin(masked))
            delta = masked[j1]
            held = [owner[j] for j in np.flatnonzero(used)]
            u[held] = u[held] + delta
            v = np.where(used, v - delta, v)
            minv = np.where(used, minv, minv - delta)
            j0 = j1
        while j0 != 0:
            j1 = way[j0]
            owner[j0] = owner[j1]
            j0 = j1
    col = np.full(n, -1)
    for j in range(1, n + 1):
        if owner[j] > 0:
            col[owner[j] - 1] = j - 1
    return col


def _dist(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Tag distance of rows ``a [R, E]`` to rows ``b [C, E]``: ``[R, C]``."""
    diff = a[:, None, :] - b[None, :, :]
    d2 = np.zeros(diff.shape[:2], np.float32)
    for i in range(diff.shape[-1]):
        d2 = d2 + diff[..., i] * diff[..., i]
    return np.sqrt(d2)


def group(cand: np.ndarray, det_thr: float, tag_thr: float):
    """``cand [K, M, 3+E]`` (joint order) -> ``(joints [M, K, 3+E], count)``."""
    k, m, f = cand.shape
    e = f - 3
    p = m
    joints = np.zeros((p, k, f), np.float32)
    tag_sum = np.zeros((p, e), np.float32)
    tag_cnt = np.zeros((p,), np.float32)
    count = 0
    one = np.float32(1.0)
    for j in JOINTS_ORDER[:k]:
        rows = cand[j]
        valid = rows[:, 2] > det_thr
        mean = tag_sum / np.maximum(tag_cnt, one)[:, None]
        dist = _dist(rows[:, 3:], mean)
        cost_real = np.round(dist) * np.float32(100.0) - rows[:, 2:3]
        live = np.arange(p) < count
        real = valid[:, None] & live[None, :]
        pad = (np.abs(cost_real[real].max()) * np.float32(2.0) + np.float32(100.0)
               if real.any() else np.float32(100.0))
        ids = np.flatnonzero(valid)
        n = max(m, p)
        cost = np.full((n, n), pad, np.float32)
        cost[:len(ids), :p] = np.where(live[None, :], cost_real[ids], pad)
        col = np.full(m, -1)
        col[ids] = hungarian(cost, len(ids))[:len(ids)]
        cc = np.clip(col, 0, p - 1)
        raw = dist[np.arange(m), cc]
        matched = valid & (col >= 0) & (col < p) & live[cc] & (raw < tag_thr)
        for r in np.flatnonzero(matched):
            joints[cc[r], j] = rows[r]
            tag_sum[cc[r]] = tag_sum[cc[r]] + rows[r, 3:]
            tag_cnt[cc[r]] += one
        for r in np.flatnonzero(valid & ~matched):
            if count < p:
                joints[count, j] = rows[r]
                tag_sum[count] = rows[r, 3:]
                tag_cnt[count] = one
                count += 1
    return joints, count


def _offsets(hm: np.ndarray, k, y, x):
    """Quarter-pixel offsets toward the higher neighbour of pixel (y, x) of
    joint map k (arrays of equal shape)."""
    _, h, w = hm.shape
    right = hm[k, y, np.minimum(x + 1, w - 1)]
    left = hm[k, y, np.maximum(x - 1, 0)]
    down = hm[k, np.minimum(y + 1, h - 1), x]
    up = hm[k, np.maximum(y - 1, 0), x]
    q = np.float32(0.25)
    return np.where(right > left, q, -q), np.where(down > up, q, -q)


def decode(hm: torch.Tensor, tags: torch.Tensor, max_people: int, det_thr: float,
           tag_thr: float):
    """One image: ``hm [K, H, W]``, ``tags [K, E, H, W]`` float32 ->
    ``(joints [M, K, 3+E], person scores [M], valid [M])`` as NumPy."""
    k, h, w = hm.shape
    m = max_people
    cand = candidates(hm, tags, m)
    joints, count = group(cand, det_thr, tag_thr)
    valid = np.arange(m) < count
    if count == 0:
        joints[0] = np.concatenate([cand[:, 0, :2], np.full((k, 1), 0.01, np.float32),
                                    cand[:, 0, 3:]], -1)
        valid[0] = True
    hm_np = hm.cpu().numpy()
    kk = np.broadcast_to(np.arange(k), joints.shape[:2])
    half = np.float32(0.5)

    # adjust: a quarter pixel toward the higher neighbour, plus half a pixel
    score = joints[..., 2]
    xi = np.clip(joints[..., 0].astype(np.int64), 0, w - 1)
    yi = np.clip(joints[..., 1].astype(np.int64), 0, h - 1)
    ox, oy = _offsets(hm_np, kk, yi, xi)
    det = score != 0.0
    joints[..., 0] = np.where(det, joints[..., 0] + ox + half, joints[..., 0])
    joints[..., 1] = np.where(det, joints[..., 1] + oy + half, joints[..., 1])
    person_scores = joints[..., 2].mean(1, dtype=np.float32)

    # refine the undetected joints of every person with a detection
    det = joints[..., 2] > 0.0
    active = np.flatnonzero(det.any(1))
    if len(active):
        xi = np.clip(joints[..., 0].astype(np.int64), 0, w - 1)
        yi = np.clip(joints[..., 1].astype(np.int64), 0, h - 1)
        tags_np = tags.cpu().numpy() if tags.shape[1] > 1 else None
        prev = np.zeros((len(active), tags.shape[1]), np.float32)
        for n, p in enumerate(active):
            s = np.zeros(tags.shape[1], np.float32)
            for j in np.flatnonzero(det[p]):
                s = s + (tags_np[j, :, yi[p, j], xi[p, j]] if tags_np is not None
                         else tags[j, :, yi[p, j], xi[p, j]].cpu().numpy())
            prev[n] = s / np.float32(det[p].sum())
        pv = torch.from_numpy(prev).to(tags.device)  # [A, E]
        t = tags.reshape(k, tags.shape[1], -1)  # [K, E, HW]
        if tags.shape[1] == 1:
            dist = (t[None, :, 0, :] - pv[:, None, 0, None]).abs()
        else:
            dist = torch.zeros((len(active), k, t.shape[-1]), dtype=torch.float32, device=t.device)
            for i in range(tags.shape[1]):
                d = t[None, :, i, :] - pv[:, None, i, None]
                dist = dist + d * d
            dist = dist.sqrt()
        idx = (hm.reshape(1, k, -1) - dist.round_()).argmax(-1).cpu().numpy()  # [A, K]
        del dist
        fy, fx = idx // w, idx % w
        ka = np.broadcast_to(np.arange(k), idx.shape)
        val = hm_np[ka, fy, fx]
        ox, oy = _offsets(hm_np, ka, fy, fx)
        sub = joints[active]
        put = (val > 0) & (sub[..., 2] == 0.0)
        sub[..., 0] = np.where(put, fx.astype(np.float32) + half + ox, sub[..., 0])
        sub[..., 1] = np.where(put, fy.astype(np.float32) + half + oy, sub[..., 1])
        sub[..., 2] = np.where(put, val, sub[..., 2])
        joints[active] = sub
    return joints, person_scores, valid
