"""Sequential AE-tag grouping: CUDA kernel wrapper and its plain version.

Replaces ``human_pose_tpu/ops/pallas_match.py::match_by_tag_pallas_batched``
(``_match_kernel_batched``). For each image, joints are processed in
``joints_order``; each step builds the cost ``round(dist)*100 - score``
between the joint's candidates and the persons grouped so far (person mean
tags), pads nonexistent-person columns with ``|max real|*2 + 100`` (100 when
there is no real pair), solves the assignment with the shortest-augmenting-
path Hungarian (rows with ``score <= det_thr`` skipped, in candidate order),
accepts a match only if the raw distance is ``< tag_thr``, and turns every
other valid candidate into a new person in candidate order, up to P persons.

``match_by_tag_batched`` and the per-image entry ``match_by_tag_per_image``
(replacing ``match_by_tag_pallas``, ``_match_kernel``) launch
``csrc/match_by_tag.cu`` on CUDA tensors and run ``match_by_tag_batched_plain``
on CPU tensors.
"""

from __future__ import annotations

import ctypes

import torch

from ..device import constant
from .hungarian import hungarian

MAX_M = 32  # candidates per joint: one row per lane of the kernel's warp
MAX_COLS = 127  # person columns; +1 virtual column = 4 columns a lane
MAX_E = 8  # embedding dims held in shared memory per person


def match_image_plain(cand: torch.Tensor, joints_order, num_persons: int,
                      det_thr: float, tag_thr: float):
    """One image: ``cand [K, M, 3+E]`` already permuted to ``joints_order``
    -> ``(joints [P, K, 3+E], count)``."""
    k, m, f = cand.shape
    e = f - 3
    p = num_persons
    n = max(m, p)  # square assignment: persons (+ pad columns) x rows
    dev = cand.device
    joints = torch.zeros((p, k, f), dtype=torch.float32, device=dev)
    tag_sum = torch.zeros((p, e), dtype=torch.float32, device=dev)
    tag_cnt = torch.zeros((p,), dtype=torch.float32, device=dev)
    count = 0
    cols = torch.arange(n, device=dev)
    for s, idx in enumerate(joints_order):
        cj = cand[s].to(torch.float32)  # [M, F]
        scores = cj[:, 2]
        tags = cj[:, 3:]
        valid = scores > det_thr
        mean = tag_sum / torch.clamp(tag_cnt, min=1.0)[:, None]
        diff = tags[:, None, :] - mean[None, :, :]  # [M, P, E]
        d2 = torch.zeros((m, p), dtype=torch.float32, device=dev)
        for ee in range(e):  # accumulate in index order from 0, like the kernel
            d2 = d2 + diff[..., ee] * diff[..., ee]
        dist = torch.sqrt(d2)
        cost_real = torch.round(dist) * 100.0 - scores[:, None]
        person_valid = cols[:p] < count
        real = valid[:, None] & person_valid[None, :]
        if bool(real.any()):
            pad = torch.abs(cost_real[real].max()) * 2.0 + 100.0
        else:
            pad = torch.tensor(100.0, device=dev)
        # valid rows first, in candidate order: the solver assigns only them
        rows = torch.nonzero(valid).flatten()
        cost = pad.expand(n, n).clone()
        cost[: len(rows), :p] = torch.where(person_valid[None, :], cost_real[rows], pad)
        col = torch.full((m,), -1, dtype=torch.int64, device=dev)
        col[rows] = hungarian(cost, num_valid_rows=len(rows))[: len(rows)]

        col_c = col.clamp(0, p - 1)
        raw_d = dist.gather(1, col_c[:, None])[:, 0]
        matched = valid & (col >= 0) & (col < p) & person_valid[col_c] & (raw_d < tag_thr)
        tgt = col_c[matched]
        joints[tgt, idx] = cj[matched]
        tag_sum[tgt] = tag_sum[tgt] + tags[matched]
        tag_cnt[tgt] = tag_cnt[tgt] + 1.0

        new = torch.nonzero(valid & ~matched).flatten()
        slots = count + torch.arange(len(new), device=dev)
        keep = slots < p
        new, slots = new[keep], slots[keep]
        joints[slots, idx] = cj[new]
        tag_sum[slots] = tags[new]
        tag_cnt[slots] = 1.0
        count = min(count + int((valid & ~matched).sum()), p)
    return joints, count


def match_by_tag_batched_plain(cand_ordered: torch.Tensor, det_thr: float, tag_thr: float,
                               joints_order, num_persons: int):
    """Plain version of the kernel: ``cand_ordered [B, K, M, 3+E]`` ->
    ``joints [B, P, K, 3+E]`` float32, ``count [B]`` int32."""
    outs = [
        match_image_plain(c, joints_order, num_persons, det_thr, tag_thr)
        for c in cand_ordered
    ]
    joints = torch.stack([j for j, _ in outs])
    count = torch.tensor([c for _, c in outs], dtype=torch.int32, device=cand_ordered.device)
    return joints, count


def _checked(cand_ordered: torch.Tensor, joints_order, num_persons: int | None):
    """``(P, E)`` of a grouping call, after the checks both entries share."""
    b, k, m, f = cand_ordered.shape
    if len(joints_order) != k or sorted(joints_order) != list(range(k)):
        raise ValueError(f"joints_order must be a permutation of range({k})")
    return num_persons or m, f - 3


def _launch(cand_ordered: torch.Tensor, det_thr: float, tag_thr: float, joints_order, p: int):
    """Launch ``csrc/match_by_tag.cu`` (one warp per image) on a CUDA tensor."""
    b, k, m, f = cand_ordered.shape
    e = f - 3
    if cand_ordered.device.type != "cuda":
        raise ValueError(f"unsupported device {cand_ordered.device}")
    if cand_ordered.dtype != torch.float32 or not cand_ordered.is_contiguous():
        raise ValueError("cand_ordered must be a contiguous float32 tensor")
    if not (1 <= m <= MAX_M and 1 <= p and max(m, p) <= MAX_COLS and 1 <= e <= MAX_E):
        raise ValueError(f"unsupported sizes M={m} P={p} E={e} (M<={MAX_M}, "
                         f"max(M,P)<={MAX_COLS}, 1<=E<={MAX_E})")
    from ._build import load_kernel

    lib = load_kernel("match_by_tag")
    dev = cand_ordered.device
    order = constant(tuple(joints_order), torch.int32, dev)
    joints = torch.empty((b, p, k, f), dtype=torch.float32, device=dev)
    count = torch.empty((b,), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.launch_match_by_tag(
        ctypes.c_void_p(cand_ordered.data_ptr()), ctypes.c_void_p(order.data_ptr()),
        ctypes.c_void_p(joints.data_ptr()), ctypes.c_void_p(count.data_ptr()),
        b, k, m, e, p, ctypes.c_float(det_thr), ctypes.c_float(tag_thr),
        ctypes.c_void_p(stream),
    )
    if err != 0:
        raise RuntimeError(f"match_by_tag kernel launch failed: cudaError {err}")
    return joints, count


def match_by_tag_batched(cand_ordered: torch.Tensor, det_thr: float, tag_thr: float,
                         joints_order, num_persons: int | None = None):
    """Batched grouping. ``cand_ordered [B, K, M, 3+E]`` float32 (x, y,
    score, tags), already permuted to ``joints_order`` along K ->
    ``joints [B, P, K, 3+E]`` float32, ``count [B]`` int32.

    CUDA tensors launch the kernel (counted in ``match_by_tag_batched.launches``);
    CPU tensors run the plain version."""
    p, _ = _checked(cand_ordered, joints_order, num_persons)
    if cand_ordered.device.type == "cpu":
        return match_by_tag_batched_plain(cand_ordered, det_thr, tag_thr, joints_order, p)
    out = _launch(cand_ordered, det_thr, tag_thr, joints_order, p)
    match_by_tag_batched.launches += 1
    return out


match_by_tag_batched.launches = 0


def match_by_tag_per_image(cand_ordered: torch.Tensor, det_thr: float = 0.1, tag_thr: float = 1.0,
                           joints_order=(), num_persons: int | None = None):
    """The per-image grouping entry, with the signature of
    ``human_pose_tpu/ops/pallas_match.py::match_by_tag_pallas`` (one image
    per grid cell there; its grid asks ``K*(3+E) <= 128``). The CUDA kernel
    already runs one warp per image, so this is the same launch as
    ``match_by_tag_batched`` with its own count
    (``match_by_tag_per_image.launches``); CPU tensors run the plain
    version."""
    p, e = _checked(cand_ordered, joints_order, num_persons)
    k = cand_ordered.shape[1]
    if k * (3 + e) > 128:
        raise ValueError(f"K*(3+E) = {k * (3 + e)} > 128")
    if cand_ordered.device.type == "cpu":
        return match_by_tag_batched_plain(cand_ordered, det_thr, tag_thr, joints_order, p)
    out = _launch(cand_ordered, det_thr, tag_thr, joints_order, p)
    match_by_tag_per_image.launches += 1
    return out


match_by_tag_per_image.launches = 0
