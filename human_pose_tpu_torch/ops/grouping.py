"""Associative-embedding keypoint decode (port of human_pose_tpu/ops/grouping.py).

* ``nms``       — 5x5 max-pool keep-equal suppression
* ``top_k``     — per-joint top-M scores/coords/tags, ties to the lowest flat
  index
* ``match_by_tag`` — sequential grouping over joints in ``JOINTS_ORDER`` with
  cost ``round(dist)*100 - score``, Hungarian assignment and the ``tag_thr``
  gate; batched through ``cuda_match.match_by_tag_batched`` (CUDA kernel on
  the card, plain version on the CPU)
* ``adjust``    — quarter-pixel offset toward the higher neighbour + 0.5
* ``refine_batch`` — recovers missing joints by maximizing
  ``heatmap - round(tag_dist)`` (``cuda_decode.refine_argmax_batch``)
* ``parse_batch`` — the pipeline, with the single-best-person fallback

Layouts: heatmaps ``[B, K, H, W]``, tag maps ``[B, K, E, H, W]`` (embedding
dim before space, so each (b, k) map is one contiguous ``[E, HW]`` block for
the refine kernel), grouped joints ``[B, P, K, 3+E]`` (x, y, score, tags).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .cuda_decode import refine_argmax_batch
from .cuda_match import match_by_tag_batched

# reference grouping.py:63-65 (1-based list converted to 0-based)
JOINTS_ORDER = tuple(
    i - 1 for i in [1, 2, 3, 4, 5, 6, 7, 12, 13, 8, 9, 10, 11, 14, 15, 16, 17]
)


def joints_order_for(k: int) -> tuple:
    """Grouping order for a k-joint skeleton: the COCO order restricted to
    existing joints, then any joints beyond 17 in index order."""
    order = tuple(j for j in JOINTS_ORDER if j < k)
    return order + tuple(range(len(JOINTS_ORDER), k))


def nms(kpts_hms: torch.Tensor, pool_size: int = 5) -> torch.Tensor:
    """Keep only local maxima of ``[B, K, H, W]`` heatmaps (pool x pool)."""
    pooled = F.max_pool2d(kpts_hms, pool_size, stride=1, padding=pool_size // 2)
    return torch.where(pooled == kpts_hms, kpts_hms, 0.0)


def _top_k(x: torch.Tensor, k: int):
    """Top-k along the last dim, value descending, ties to the lowest index
    (a stable sort keeps equal values in index order)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _chunked_top_k(flat: torch.Tensor, k_want: int, chunk: int = 256):
    """Exact top-k of ``[R, N]`` by chunk-max selection: the per-chunk max
    picks the ``k_want`` best chunks (lower chunk id on ties), whose contents
    are gathered in ascending chunk order for a small exact top-k. No element
    of a dropped chunk can rank in the top k, and gathering in chunk order
    keeps flat-index order, so ties resolve to the lowest flat index exactly
    as one big sort would (proof in the JAX package's ``_chunked_top_k``)."""
    r, n = flat.shape
    n_chunks = -(-n // chunk)
    if n <= chunk * 4 or n_chunks <= k_want:
        return _top_k(flat, k_want)
    pad = n_chunks * chunk - n
    if pad:
        flat = F.pad(flat, (0, pad), value=float("-inf"))
    chunked = flat.view(r, n_chunks, chunk)
    _, chunk_ids = _top_k(chunked.amax(dim=-1), k_want)
    chunk_ids, _ = torch.sort(chunk_ids, dim=-1)
    picked = torch.gather(chunked, 1, chunk_ids[..., None].expand(r, k_want, chunk))
    vals, pos = _top_k(picked.reshape(r, k_want * chunk), k_want)
    src_chunk = torch.gather(chunk_ids, 1, pos // chunk)
    return vals, src_chunk * chunk + pos % chunk


def top_k(kpts_hms: torch.Tensor, tags_hms: torch.Tensor, max_num_people: int):
    """Per-joint top-M detections after NMS.

    ``kpts_hms [B, K, H, W]``, ``tags_hms [B, K, E, H, W]`` ->
    ``tags_k [B, K, M, E]``, ``coords_k [B, K, M, 2]`` int32 (x, y),
    ``scores_k [B, K, M]`` (sorted descending)."""
    b, k, h, w = kpts_hms.shape
    e = tags_hms.shape[2]
    flat = nms(kpts_hms).reshape(b * k, h * w)
    scores, idxs = _chunked_top_k(flat, max_num_people)
    scores = scores.view(b, k, -1)
    idxs = idxs.view(b, k, -1)
    coords = torch.stack([idxs % w, idxs // w], dim=-1).to(torch.int32)
    tags_flat = tags_hms.reshape(b, k, e, h * w)
    tags_k = torch.gather(tags_flat, 3, idxs[:, :, None, :].expand(b, k, e, idxs.shape[-1]))
    return tags_k.transpose(2, 3), coords, scores


def _candidates(tags_k, coords_k, scores_k):
    """``[..., M, 3+E]`` rows (x, y, score, tags) in float32."""
    return torch.cat([coords_k.to(torch.float32), scores_k[..., None], tags_k], dim=-1)


def match_by_tag(tags_k, coords_k, scores_k, det_thr: float = 0.1, tag_thr: float = 1.0,
                 joints_order=None):
    """Single-image grouping, the JAX package's signature: ``tags_k [K, M, E]``,
    ``coords_k [K, M, 2]``, ``scores_k [K, M]`` -> ``(joints [P, K, 3+E],
    valid [P])`` with P == M."""
    k, m, _ = tags_k.shape
    order = tuple(joints_order) if joints_order is not None else joints_order_for(k)
    cand = _candidates(tags_k, coords_k, scores_k)[list(order)]
    joints, count = match_by_tag_batched(cand[None].contiguous(), det_thr, tag_thr, order, m)
    valid = torch.arange(m, device=tags_k.device) < count[0]
    return joints[0], valid


def _gather_hw(hms: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """``hms [B, K, H, W]`` at integer ``ys, xs [B, P, K]`` -> ``[B, P, K]``."""
    b, k, h, w = hms.shape
    p = ys.shape[1]
    flat = (ys * w + xs).permute(0, 2, 1).reshape(b, k, p)  # [B, K, P]
    return torch.gather(hms.reshape(b, k, h * w), 2, flat).permute(0, 2, 1)


def _offsets(hms, ys, xs):
    """Quarter-pixel offsets toward the higher neighbour in x and y."""
    h, w = hms.shape[2:]
    right = _gather_hw(hms, ys, torch.clamp(xs + 1, max=w - 1))
    left = _gather_hw(hms, ys, torch.clamp(xs - 1, min=0))
    down = _gather_hw(hms, torch.clamp(ys + 1, max=h - 1), xs)
    up = _gather_hw(hms, torch.clamp(ys - 1, min=0), xs)
    return torch.where(right > left, 0.25, -0.25), torch.where(down > up, 0.25, -0.25)


def adjust(grouped: torch.Tensor, kpts_hms: torch.Tensor) -> torch.Tensor:
    """Quarter-pixel offset toward the higher neighbour + 0.5 center shift
    for detected joints. ``grouped [B, P, K, 3+E]``, ``kpts_hms [B, K, H, W]``."""
    h, w = kpts_hms.shape[2:]
    x, y, score = grouped[..., 0], grouped[..., 1], grouped[..., 2]
    xi = torch.clamp(x.to(torch.int64), 0, w - 1)
    yi = torch.clamp(y.to(torch.int64), 0, h - 1)
    ox, oy = _offsets(kpts_hms, yi, xi)
    keep = score == 0.0
    out = grouped.clone()
    out[..., 0] = torch.where(keep, x, x + ox + 0.5)
    out[..., 1] = torch.where(keep, y, y + oy + 0.5)
    return out


def refine_batch(kpts_hms: torch.Tensor, tags_hms: torch.Tensor, grouped: torch.Tensor) -> torch.Tensor:
    """Recover missing joints of every person with a detection.

    ``kpts_hms [B, K, H, W]``, ``tags_hms [B, K, E, H, W]``, ``grouped
    [B, P, K, 3+E]``. The refine kernel's person bound is derived here from
    the joints — last person slot with any detected joint, +1 — so it holds
    for any slot layout."""
    b, p, k, _ = grouped.shape
    e = tags_hms.shape[2]
    h, w = kpts_hms.shape[2:]
    dev = grouped.device
    score = grouped[..., 2]
    det = score > 0.0
    has_det = det.any(dim=2)  # [B, P]
    slots = torch.arange(p, device=dev)[None, :].expand(b, p)
    counts = (torch.where(has_det, slots, -1).amax(dim=1) + 1).to(torch.int32)
    xi = torch.clamp(grouped[..., 0].to(torch.int64), 0, w - 1)
    yi = torch.clamp(grouped[..., 1].to(torch.int64), 0, h - 1)
    tags_flat = tags_hms.reshape(b, k, e, h * w)
    pix = (yi * w + xi).permute(0, 2, 1)  # [B, K, P]
    det_tags = torch.gather(tags_flat, 3, pix[:, :, None, :].expand(b, k, e, p))  # [B, K, E, P]
    det_tags = det_tags.permute(0, 3, 1, 2)  # [B, P, K, E]
    n_det = torch.clamp(det.sum(dim=2).to(torch.float32), min=1.0)
    prev_tag = torch.where(det[..., None], det_tags, 0.0).sum(dim=2) / n_det[..., None]

    idx = refine_argmax_batch(
        kpts_hms.reshape(b, k, h * w).contiguous(), tags_flat.contiguous(),
        prev_tag.contiguous(), counts,
    )  # [B, K, P]
    flat_idx = idx.permute(0, 2, 1).to(torch.int64)  # [B, P, K]
    fy, fx = flat_idx // w, flat_idx % w
    val = _gather_hw(kpts_hms, fy, fx)
    ox, oy = _offsets(kpts_hms, fy, fx)
    new_x = fx.to(torch.float32) + 0.5 + ox
    new_y = fy.to(torch.float32) + 0.5 + oy

    replace = (val > 0.0) & (score == 0.0) & (det.sum(dim=2, keepdim=True) > 0)
    out = grouped.clone()
    out[..., 0] = torch.where(replace, new_x, grouped[..., 0])
    out[..., 1] = torch.where(replace, new_y, grouped[..., 1])
    out[..., 2] = torch.where(replace, val, grouped[..., 2])
    return out


def group_from_candidates(tags_k, coords_k, scores_k, *, det_thr: float, tag_thr: float):
    """AE grouping + fallback person from per-joint top-k candidates.

    ``tags_k [B, K, M, E]``, ``coords_k [B, K, M, 2]``, ``scores_k [B, K, M]``
    -> ``(grouped [B, M, K, 3+E], valid [B, M])``."""
    b, k, m, e = tags_k.shape
    order = joints_order_for(k)
    cand = _candidates(tags_k, coords_k, scores_k)[:, list(order)].contiguous()
    grouped, count = match_by_tag_batched(cand, det_thr, tag_thr, order, m)
    valid = torch.arange(m, device=cand.device)[None, :] < count[:, None]

    # no grouped person -> one person of each joint's best candidate, score
    # 0.01 (reference grouping.py:262-269)
    need_fb = ~valid.any(dim=1)  # [B]
    fb_person = torch.cat([
        coords_k[:, :, 0].to(torch.float32),
        torch.full((b, k, 1), 0.01, dtype=torch.float32, device=cand.device),
        tags_k[:, :, 0],
    ], dim=-1)  # [B, K, 3+E]
    fb_joints = torch.zeros_like(grouped)
    fb_joints[:, 0] = fb_person
    fb_valid = torch.zeros_like(valid)
    fb_valid[:, 0] = True
    grouped = torch.where(need_fb[:, None, None, None], fb_joints, grouped)
    valid = torch.where(need_fb[:, None], fb_valid, valid)
    return grouped, valid


def parse_batch(kpts_hms: torch.Tensor, tags_hms: torch.Tensor, max_num_people: int = 30,
                det_thr: float = 0.1, tag_thr: float = 1.0, do_adjust: bool = True,
                do_refine: bool = True):
    """Batched decode of ``kpts_hms [B, K, H, W]`` and ``tags_hms
    [B, K, E, H, W]`` float32 -> ``joints [B, P, K, 3+E]`` (x, y, score,
    tags), ``person_scores [B, P]`` (mean joint score before refine),
    ``valid [B, P]``."""
    tags_k, coords_k, scores_k = top_k(kpts_hms, tags_hms, max_num_people)
    grouped, valid = group_from_candidates(
        tags_k, coords_k, scores_k, det_thr=det_thr, tag_thr=tag_thr
    )
    if do_adjust:
        grouped = adjust(grouped, kpts_hms)
    person_scores = grouped[..., 2].mean(dim=2)
    if do_refine:
        grouped = refine_batch(kpts_hms, tags_hms, grouped)
    return grouped, person_scores, valid
