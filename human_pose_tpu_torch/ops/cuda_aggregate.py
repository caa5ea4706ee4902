"""Fused decode front end: CUDA kernel wrappers and their plain versions.

Replaces ``human_pose_tpu/ops/pallas_aggregate.py``:

* ``fused_aggregate`` (``_aggregate_kernel``): 2x upsample of the
  quarter-resolution stage, average with the half-resolution stage, 2x
  upsample to input size, 5x5 keep-equal NMS and per-row maxima, with the
  maps returned in the 4x4 phase layout (``ops/phase.py``). Each 2x upsample
  runs down the rows first, then along them, as ``out[2u] = 0.25*M[u-1] +
  0.75*M[u]`` and ``out[2u+1] = 0.75*M[u] + 0.25*M[u+1]`` with exact copies
  at the edges: the JAX kernel's float32 operation sequence, which
  ``F.interpolate`` (columns first) does not repeat bit for bit.
* ``refine_argmax_phase_batch`` (``_refine_phase_kernel``): the refine
  argmax on the phase-layout heatmap with the quarter-resolution tags
  upsampled 4x on the fly; the distance is ``sqrt`` of the summed squares
  even for one embedding dim (the dense refine's ``|d|`` is the JAX dense
  path's form, not this kernel's), and every person slot is computed. The
  kernel splits each map's rows over several blocks
  (``phase_refine_splits``) and merges their partial results exactly.

The wrappers launch ``csrc/fused_aggregate.cu`` and
``csrc/refine_argmax_phase.cu`` on CUDA tensors and run the plain versions
on CPU tensors.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from .cuda_decode import MAX_E, refine_splits, run_person_chunks
from .phase import UP4_W, dense_to_phase, phase_to_dense

MAX_SMEM = 200 * 1024  # bytes of shared memory a kernel block may ask for


def _up2(m: torch.Tensor, dim: int) -> torch.Tensor:
    """2x ``align_corners=False`` upsample along ``dim`` (edges copied)."""
    n = m.shape[dim]
    first, last = m.narrow(dim, 0, 1), m.narrow(dim, n - 1, 1)
    prev = torch.cat([first, m.narrow(dim, 0, n - 1)], dim)
    nxt = torch.cat([m.narrow(dim, 1, n - 1), last], dim)
    even = 0.25 * prev + 0.75 * m
    odd = 0.75 * m + 0.25 * nxt
    even.narrow(dim, 0, 1).copy_(first)
    odd.narrow(dim, n - 1, 1).copy_(last)
    return torch.stack([even, odd], dim + 1).flatten(dim, dim + 1)


def _up4(m: torch.Tensor, dim: int) -> torch.Tensor:
    """Direct 4x ``align_corners=False`` upsample along ``dim`` with the
    ``UP4_W`` taps (edges copied)."""
    n = m.shape[dim]
    first, last = m.narrow(dim, 0, 1), m.narrow(dim, n - 1, 1)
    prev = torch.cat([first, m.narrow(dim, 0, n - 1)], dim)
    nxt = torch.cat([m.narrow(dim, 1, n - 1), last], dim)
    outs = []
    for r, (wl, wr) in enumerate(UP4_W):
        if r < 2:
            o = wl * prev + wr * m
            o.narrow(dim, 0, 1).copy_(first)
        else:
            o = wl * m + wr * nxt
            o.narrow(dim, n - 1, 1).copy_(last)
        outs.append(o)
    return torch.stack(outs, dim + 1).flatten(dim, dim + 1)


def fused_aggregate_plain(q: torch.Tensor, h2: torch.Tensor):
    """Plain version of the kernel; same arguments as ``fused_aggregate``."""
    avg = _up2(_up2(q, 2), 3)
    avg = (avg + h2) * 0.5
    avg = _up2(_up2(avg, 2), 3)  # [B, K, H, W]
    pooled = F.max_pool2d(avg, 5, stride=1, padding=2)  # pads with -inf
    sup = torch.where(pooled == avg, avg, 0.0)
    b, k, h, _ = sup.shape
    cmax = sup.amax(dim=3).reshape(b, k, h // 4, 4).transpose(2, 3).contiguous()
    return dense_to_phase(avg), dense_to_phase(sup), cmax


def _float32_on(dev, **tensors):
    for name, t in tensors.items():
        if t.device != dev or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous float32 tensor on {dev}")


AGG_MAX_THREADS = 256  # a block's most lanes (the kernel's launch bound), one 4-pixel group each
AGG_BLOCKS_PER_SM = 24  # strips a map is cut into: about this many blocks an SM


def aggregate_launch(maps: int, h4: int, w4: int, sm_count: int) -> tuple[int, int]:
    """``(rows, threads)`` of the kernel's launch for ``maps = B * K`` maps of
    ``H4 x W4``: ``rows`` quarter rows a block (a strip, 1 .. H4), enough
    strips for at least ``AGG_BLOCKS_PER_SM`` blocks an SM; ``threads`` lanes a
    block, one a quarter column, whole warps, at most ``AGG_MAX_THREADS``
    (wider rows run as column tiles inside the block). The kernel takes no
    dynamic shared memory."""
    rows = min(h4, max(1, maps * h4 // (sm_count * AGG_BLOCKS_PER_SM)))
    return rows, min(AGG_MAX_THREADS, 32 * -(-w4 // 32))


def fused_aggregate(q: torch.Tensor, h2: torch.Tensor, rows: int | None = None):
    """Aggregate, upsample, NMS and row maxima in one pass.

    ``q [B, K, H4, W4]`` float32 quarter-resolution heatmaps, ``h2 [B, K,
    2*H4, 2*W4]`` float32 half-resolution ones -> ``avg_phase, sup_phase
    [B, K, 4, 4, H4, W4]`` (averaged full-resolution map and its NMS-
    suppressed copy, phase layout) and ``cmax [B, K, 4, H4]`` (``cmax[..., ry,
    i]`` is the maximum of sup's full-resolution row ``4i + ry``).

    CUDA tensors launch the kernel (counted in ``fused_aggregate.launches``);
    CPU tensors run the plain version. ``rows`` sets the quarter rows a block
    walks down (default ``aggregate_launch``; tests and timing sweeps set
    it); the result does not depend on it."""
    b, k, h4, w4 = q.shape
    if tuple(h2.shape) != (b, k, 2 * h4, 2 * w4):
        raise ValueError(f"shape mismatch: q {tuple(q.shape)} h2 {tuple(h2.shape)}")
    if q.device.type == "cpu":
        return fused_aggregate_plain(q, h2)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    _float32_on(q.device, q=q, h2=h2)
    sm_count = torch.cuda.get_device_properties(q.device).multi_processor_count
    default_rows, threads = aggregate_launch(b * k, h4, w4, sm_count)
    rows = default_rows if rows is None else rows
    if not 1 <= rows <= h4:
        raise ValueError(f"rows={rows} outside 1..H4={h4}")
    from ._build import load_kernel

    lib = load_kernel("fused_aggregate")
    avg = torch.empty((b, k, 4, 4, h4, w4), dtype=torch.float32, device=q.device)
    sup = torch.empty_like(avg)
    cmax = torch.empty((b, k, 4, h4), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.launch_fused_aggregate(
        ctypes.c_void_p(q.data_ptr()), ctypes.c_void_p(h2.data_ptr()),
        ctypes.c_void_p(avg.data_ptr()), ctypes.c_void_p(sup.data_ptr()),
        ctypes.c_void_p(cmax.data_ptr()), b, k, h4, w4, rows, threads, ctypes.c_void_p(stream),
    )
    if err != 0:
        raise RuntimeError(f"fused_aggregate kernel launch failed: cudaError {err}")
    fused_aggregate.launches += 1
    return avg, sup, cmax


fused_aggregate.launches = 0


def refine_argmax_phase_batch_plain(avg_phase: torch.Tensor, tags_lo: torch.Tensor,
                                    prev: torch.Tensor):
    """Plain version of the kernel; same arguments as
    ``refine_argmax_phase_batch``. One image at a time, so the largest
    temporary is ``[K, P, H*W]``, never ``[B, K, P, H*W]``."""
    b, k = avg_phase.shape[:2]
    e = tags_lo.shape[2]
    hm = phase_to_dense(avg_phase).reshape(b, k, -1)  # [B, K, HW]
    tag_up = _up4(_up4(tags_lo, 3), 4).reshape(b, k, e, -1)  # [B, K, E, HW]
    idx = torch.empty((b, k, prev.shape[1]), dtype=torch.int64, device=avg_phase.device)
    for bi in range(b):
        acc = None
        for ee in range(e):  # summed in index order from 0, like the kernel
            d = tag_up[bi, :, ee, None, :] - prev[bi, None, :, ee, None]  # [K, P, HW]
            acc = d * d if acc is None else acc + d * d
        diff = hm[bi, :, None, :] - torch.round(torch.sqrt(acc))
        idx[bi] = torch.argmax(diff, dim=2)  # first maximum
    val = torch.gather(hm, 2, idx)
    return idx.to(torch.int32), val


def phase_refine_splits(maps: int, h4: int, w4: int, e: int, sm_count: int) -> int:
    """Blocks that share the ``4*H4`` full-resolution rows of one of the
    ``maps = B * K`` maps: ``cuda_decode.refine_splits`` for a map of
    ``16*H4*W4`` pixels, at most one block a row, and more blocks while a
    block's staged tag rows would not fit in ``MAX_SMEM``."""
    h = 4 * h4
    splits = min(refine_splits(maps, 16 * h4 * w4, sm_count), h)
    while staged_bytes(h4, w4, e, splits) > MAX_SMEM and splits < h:
        splits += 1
    return splits


def staged_bytes(h4: int, w4: int, e: int, splits: int) -> int:
    """Shared memory of the quarter-resolution tag rows (halo included) that
    a block of the kernel stages when ``splits`` blocks share a map. The
    launch is given this many bytes and refuses them if a block's rows
    (``staged_span`` in the kernel) would not fit."""
    rows_per = -(-4 * h4 // splits)
    return 4 * e * w4 * min(h4, rows_per // 4 + 4)


def refine_argmax_phase_batch(avg_phase: torch.Tensor, tags_lo: torch.Tensor, prev: torch.Tensor,
                              splits: int | None = None):
    """Refine argmax on phase-layout heatmaps and quarter-resolution tags.

    ``avg_phase [B, K, 4, 4, H4, W4]`` float32 (``fused_aggregate``'s
    layout), ``tags_lo [B, K, E, H4, W4]`` float32, ``prev [B, P, E]``
    float32 person mean tags -> ``idx [B, K, P]`` int32, the full-resolution
    flat index ``y * 4*W4 + x`` of the first (row-major) maximum of
    ``hm - round(||tag - prev||)``, and ``val [B, K, P]`` float32, the
    heatmap there.

    CUDA tensors launch the kernel, once per ``cuda_decode.MAX_P`` persons
    (each launch counted in ``refine_argmax_phase_batch.launches``); CPU tensors run the
    plain version. ``splits`` sets the blocks that share a map's rows
    (default ``phase_refine_splits``; tests and timing sweeps set it); the
    result does not depend on it."""
    b, k, _, _, h4, w4 = avg_phase.shape
    e = tags_lo.shape[2]
    p = prev.shape[1]
    if (tuple(avg_phase.shape[2:4]) != (4, 4) or tuple(tags_lo.shape) != (b, k, e, h4, w4)
            or tuple(prev.shape) != (b, p, e)):
        raise ValueError(f"shape mismatch: avg_phase {tuple(avg_phase.shape)} "
                         f"tags_lo {tuple(tags_lo.shape)} prev {tuple(prev.shape)}")
    if avg_phase.device.type == "cpu":
        return refine_argmax_phase_batch_plain(avg_phase, tags_lo, prev)
    if avg_phase.device.type != "cuda":
        raise ValueError(f"unsupported device {avg_phase.device}")
    _float32_on(avg_phase.device, avg_phase=avg_phase, tags_lo=tags_lo, prev=prev)
    if not (p >= 1 and 1 <= e <= MAX_E):
        raise ValueError(f"unsupported sizes P={p} E={e} (P>=1, E<={MAX_E})")
    if splits is None:
        sm_count = torch.cuda.get_device_properties(avg_phase.device).multi_processor_count
        splits = phase_refine_splits(b * k, h4, w4, e, sm_count)
    if not 1 <= splits <= 65535 or staged_bytes(h4, w4, e, splits) > MAX_SMEM:
        raise ValueError(f"splits={splits} outside 1..65535 or its staged tag rows "
                         f"({staged_bytes(h4, w4, e, splits)} bytes) over {MAX_SMEM}")
    return run_person_chunks(lambda pc, _: _launch_phase(avg_phase, tags_lo, pc, splits), prev)


def _launch_phase(avg_phase, tags_lo, prev, splits):
    """One kernel launch for at most ``cuda_decode.MAX_P`` persons."""
    from ._build import load_kernel

    b, k, _, _, h4, w4 = avg_phase.shape
    e, p = tags_lo.shape[2], prev.shape[1]
    lib = load_kernel("refine_argmax_phase")
    idx = torch.empty((b, k, p), dtype=torch.int32, device=avg_phase.device)
    val = torch.empty((b, k, p), dtype=torch.float32, device=avg_phase.device)
    # the blocks' partial (maximum's key, first group) pairs, merged by the second kernel
    scratch = torch.empty((2, b * k, splits, p), dtype=torch.int32, device=avg_phase.device)
    stream = torch.cuda.current_stream(avg_phase.device).cuda_stream
    err = lib.launch_refine_argmax_phase(
        ctypes.c_void_p(avg_phase.data_ptr()), ctypes.c_void_p(tags_lo.data_ptr()),
        ctypes.c_void_p(prev.data_ptr()), ctypes.c_void_p(idx.data_ptr()),
        ctypes.c_void_p(val.data_ptr()), ctypes.c_void_p(scratch.data_ptr()), b, k, h4, w4, e, p,
        splits, staged_bytes(h4, w4, e, splits), ctypes.c_void_p(stream),
    )
    if err != 0:
        raise RuntimeError(f"refine_argmax_phase kernel launch failed: cudaError {err}")
    refine_argmax_phase_batch.launches += 1
    return idx, val


refine_argmax_phase_batch.launches = 0
