"""Refine argmax: CUDA kernel wrapper and its plain version.

Replaces ``human_pose_tpu/ops/pallas_decode.py::refine_argmax_batch``
(``_refine_kernel`` / ``_refine_chunk``). For each image b, joint k and
person ``p < counts[b]`` it returns the flat position of
``argmax_HW(hm[b, k] - round(||tags[b, k, :, .] - prev[b, p]||))``, the first
maximum in row-major order. With one embedding dim the distance is ``|d|``
(not ``sqrt(d*d)``); with more it is ``sqrt`` of the squares summed in index
order. Persons ``p >= counts[b]`` are skipped and get 0 — callers never
consume them. The heatmap value at the argmax is gathered by the caller.

``refine_argmax_batch`` launches ``csrc/refine_argmax.cu`` on CUDA tensors
and runs ``refine_argmax_batch_plain`` on CPU tensors. The kernel splits each
``(b, k)`` row over several blocks (``refine_splits``) so that the grid
fills the card whatever ``B * K`` is; the blocks' partial results meet in
scratch memory allocated here and are merged exactly, so the split changes
no result.
"""

from __future__ import annotations

import ctypes

import torch

MAX_P = 32  # persons held in registers per thread
MAX_E = 4  # embedding dims with a compiled kernel instance
BLOCKS_PER_SM = 24  # blocks the grid aims at per multiprocessor: many short waves, a short tail
MIN_SPLIT_PIXELS = 4096  # a block's least share of a row: 4 steps of 256 threads x 4 pixels


def refine_splits(rows: int, hw: int, sm_count: int) -> int:
    """Blocks that share one of the ``rows = B * K`` rows of ``hw`` pixels:
    enough for ``BLOCKS_PER_SM`` blocks per multiprocessor, as long as each
    keeps ``MIN_SPLIT_PIXELS`` pixels; at most the grid's 65535."""
    want = -(-BLOCKS_PER_SM * sm_count // rows)
    return max(1, min(want, hw // MIN_SPLIT_PIXELS, 65535))


def tag_distance(tags: torch.Tensor, prev: torch.Tensor) -> torch.Tensor:
    """``tags [..., E, HW]``, ``prev [E]`` -> ``||tags - prev||`` over E,
    with the kernel's arithmetic: ``|d|`` for E=1, else squares summed from 0
    in index order, then ``sqrt``."""
    e = tags.shape[-2]
    if e == 1:
        return torch.abs(tags[..., 0, :] - prev[0])
    d2 = torch.zeros_like(tags[..., 0, :])
    for i in range(e):
        d = tags[..., i, :] - prev[i]
        d2 = d2 + d * d
    return torch.sqrt(d2)


def refine_argmax_batch_plain(hm: torch.Tensor, tags: torch.Tensor, prev: torch.Tensor,
                              counts: torch.Tensor) -> torch.Tensor:
    """Plain version of the kernel; same arguments as ``refine_argmax_batch``."""
    b, k, _ = hm.shape
    p = prev.shape[1]
    idx = torch.zeros((b, k, p), dtype=torch.int32, device=hm.device)
    for bi, cnt in enumerate(counts.tolist()):
        for pi in range(min(int(cnt), p)):
            diff = hm[bi] - torch.round(tag_distance(tags[bi], prev[bi, pi]))
            idx[bi, :, pi] = torch.argmax(diff, dim=1).to(torch.int32)  # first max
    return idx


def refine_argmax_batch(hm: torch.Tensor, tags: torch.Tensor, prev: torch.Tensor,
                        counts: torch.Tensor, splits: int | None = None) -> torch.Tensor:
    """``hm [B, K, HW]`` f32, ``tags [B, K, E, HW]`` f32, ``prev [B, P, E]``
    f32, ``counts [B]`` i32 -> ``idx [B, K, P]`` i32.

    CUDA tensors launch the kernel (counted in ``refine_argmax_batch.launches``);
    CPU tensors run the plain version. ``splits`` sets the blocks per row
    (default ``refine_splits``; tests and timing sweeps set it); the result
    does not depend on it."""
    b, k, hw = hm.shape
    e = tags.shape[2]
    p = prev.shape[1]
    if tags.shape != (b, k, e, hw) or prev.shape != (b, p, e) or counts.shape != (b,):
        raise ValueError(
            f"shape mismatch: hm {tuple(hm.shape)} tags {tuple(tags.shape)} "
            f"prev {tuple(prev.shape)} counts {tuple(counts.shape)}"
        )
    if hm.device.type == "cpu":
        return refine_argmax_batch_plain(hm, tags, prev, counts)
    if hm.device.type != "cuda":
        raise ValueError(f"unsupported device {hm.device}")
    for name, t, dt in (("hm", hm, torch.float32), ("tags", tags, torch.float32),
                        ("prev", prev, torch.float32), ("counts", counts, torch.int32)):
        if t.device != hm.device or t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {dt} tensor on {hm.device}")
    if not (1 <= p <= MAX_P and 1 <= e <= MAX_E):
        raise ValueError(f"unsupported sizes P={p} E={e} (P<={MAX_P}, E<={MAX_E})")
    from ._build import load_kernel

    if splits is None:
        sm_count = torch.cuda.get_device_properties(hm.device).multi_processor_count
        splits = refine_splits(b * k, hw, sm_count)
    if not 1 <= splits <= 65535:
        raise ValueError(f"splits={splits} outside 1..65535")
    lib = load_kernel("refine_argmax")
    idx = torch.empty((b, k, p), dtype=torch.int32, device=hm.device)
    # the blocks' partial (maximum's key, first group) pairs, merged by the second kernel
    scratch = torch.empty((2, b * k, splits, p), dtype=torch.int32, device=hm.device)
    stream = torch.cuda.current_stream(hm.device).cuda_stream
    err = lib.launch_refine_argmax(
        ctypes.c_void_p(hm.data_ptr()), ctypes.c_void_p(tags.data_ptr()),
        ctypes.c_void_p(prev.data_ptr()), ctypes.c_void_p(counts.data_ptr()),
        ctypes.c_void_p(idx.data_ptr()), ctypes.c_void_p(scratch.data_ptr()), b, k, hw, e, p,
        splits, ctypes.c_void_p(stream),
    )
    if err != 0:
        raise RuntimeError(f"refine_argmax kernel launch failed: cudaError {err}")
    refine_argmax_batch.launches += 1
    return idx


refine_argmax_batch.launches = 0
