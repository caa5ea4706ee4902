"""Refine argmax: CUDA kernel wrapper and its plain version.

Replaces ``human_pose_tpu/ops/pallas_decode.py::refine_argmax_batch``
(``_refine_kernel`` / ``_refine_chunk``). For each image b, joint k and
person ``p < counts[b]`` it returns the flat position of
``argmax_HW(hm[b, k] - round(||tags[b, k, :, .] - prev[b, p]||))``, the first
maximum in row-major order. With one embedding dim the distance is ``|d|``
(not ``sqrt(d*d)``); with more it is ``sqrt`` of the squares summed in index
order. Persons ``p >= counts[b]`` are skipped and get 0 — callers never
consume them; ``counts=None`` refines all P persons.

One difference from the JAX function's signature: ``refine_argmax_batch``
returns ``idx`` alone, not ``(idx, val)``, because its caller gathers the
heatmap value together with the neighbours it reads anyway
(``grouping._write_refined``); ``refine_argmax`` (one image) returns the pair,
as the JAX function of that name does.

``refine_argmax_batch`` launches ``csrc/refine_argmax.cu`` on CUDA tensors
and runs ``refine_argmax_batch_plain`` on CPU tensors. The kernel splits each
``(b, k)`` row over several blocks (``refine_splits``) so that the grid
fills the card whatever ``B * K`` is; the blocks' partial results meet in
scratch memory allocated here and are merged exactly, so the split changes
no result. A kernel launch holds at most ``MAX_P`` persons in registers;
more persons run as several launches over the same maps
(``run_person_chunks``), as the JAX kernel runs its chunks of 8.
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


def run_person_chunks(launch, prev: torch.Tensor, counts: torch.Tensor | None = None):
    """``launch(prev_chunk, counts_chunk)`` over the persons of ``prev [B, P,
    E]`` in chunks of at most ``MAX_P``, its results joined along the last
    (person) axis. Chunk ``[c0, c1)`` gets ``counts - c0`` clamped to
    ``[0, c1 - c0]`` (None stays None). A result is a tensor or a tuple of
    tensors. With ``P <= MAX_P`` it is one call on the arguments as given."""
    p = prev.shape[1]
    if p <= MAX_P:
        return launch(prev, counts)
    outs = []
    for c0 in range(0, p, MAX_P):
        c1 = min(c0 + MAX_P, p)
        part = None if counts is None else (counts - c0).clamp(0, c1 - c0).to(counts.dtype)
        outs.append(launch(prev[:, c0:c1].contiguous(), part))
    if isinstance(outs[0], tuple):
        return tuple(torch.cat(parts, dim=-1) for parts in zip(*outs))
    return torch.cat(outs, dim=-1)


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
                              counts: torch.Tensor | None = None) -> torch.Tensor:
    """Plain version of the kernel; same arguments as ``refine_argmax_batch``."""
    b, k, _ = hm.shape
    p = prev.shape[1]
    idx = torch.zeros((b, k, p), dtype=torch.int32, device=hm.device)
    for bi, cnt in enumerate([p] * b if counts is None else counts.tolist()):
        for pi in range(min(int(cnt), p)):
            diff = hm[bi] - torch.round(tag_distance(tags[bi], prev[bi, pi]))
            idx[bi, :, pi] = torch.argmax(diff, dim=1).to(torch.int32)  # first max
    return idx


def refine_argmax_batch(hm: torch.Tensor, tags: torch.Tensor, prev: torch.Tensor,
                        counts: torch.Tensor | None = None, splits: int | None = None) -> torch.Tensor:
    """``hm [B, K, HW]`` f32, ``tags [B, K, E, HW]`` f32, ``prev [B, P, E]``
    f32, ``counts [B]`` i32 or None (all P persons) -> ``idx [B, K, P]`` i32.

    CUDA tensors launch the kernel, once per ``MAX_P`` persons (each launch
    counted in ``refine_argmax_batch.launches``); CPU tensors run the plain
    version. ``splits`` sets the blocks per row (default ``refine_splits``;
    tests and timing sweeps set it); the result does not depend on it."""
    b, k, hw = hm.shape
    e = tags.shape[2]
    p = prev.shape[1]
    if counts is None:
        counts = torch.full((b,), p, dtype=torch.int32, device=hm.device)
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
    if not (p >= 1 and 1 <= e <= MAX_E):
        raise ValueError(f"unsupported sizes P={p} E={e} (P>=1, E<={MAX_E})")
    if splits is None:
        sm_count = torch.cuda.get_device_properties(hm.device).multi_processor_count
        splits = refine_splits(b * k, hw, sm_count)
    if not 1 <= splits <= 65535:
        raise ValueError(f"splits={splits} outside 1..65535")
    return run_person_chunks(lambda pc, cc: _launch(hm, tags, pc, cc, splits), prev, counts)


def _launch(hm, tags, prev, counts, splits):
    """One kernel launch for at most ``MAX_P`` persons."""
    from ._build import load_kernel

    b, k, hw = hm.shape
    e, p = tags.shape[2], prev.shape[1]
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


def refine_argmax(hm: torch.Tensor, tags: torch.Tensor, prev: torch.Tensor):
    """One image: ``hm [K, HW]``, ``tags [K, E, HW]``, ``prev [P, E]`` ->
    ``(idx [K, P] int32, val [K, P] float32)``, every person refined and
    ``val`` the heatmap at ``idx`` (the JAX single-image function's
    signature and result)."""
    idx = refine_argmax_batch(hm[None].contiguous(), tags[None].contiguous(),
                              prev[None].contiguous())[0]
    return idx, torch.gather(hm, 1, idx.to(torch.int64))
