"""The native heatmap splat and RLE decode (port of
human_pose_tpu/data/native.py).

``csrc/heatmap_splat.cpp`` and ``csrc/rle_decode.cpp`` are the port's own
copies of the JAX package's C++ splat and RLE decode
(``native/hp_native.cpp``) behind a plain C interface. They are built with
the host C++ compiler at first use (``ops/_build.py``) and called through
``ctypes``, which releases the GIL for the call, so the loader's worker
threads run them in parallel. There is no silent fallback: a failed build
raises with the compiler's output. The NumPy loops of ``data/targets.py``
(``HeatmapGenerator.plain``) and ``data/rle.py`` (``rle_to_mask_plain``)
are the plain versions.
"""

from __future__ import annotations

import numpy as np

from ..ops._build import load_host_library


def splat_heatmaps_native(joints: np.ndarray, size: int, sigma: float) -> np.ndarray:
    """joints int32 ``[P, K, 3]`` (x, y, vis) -> float32 ``[size, size, K]``:
    the max-combined Gaussian splat of ``HeatmapGenerator``."""
    j = np.ascontiguousarray(joints, np.int32)
    if j.ndim != 3 or j.shape[2] != 3 or j.shape[1] == 0:
        raise ValueError(f"joints must be [P, K, 3] with K > 0, got {j.shape}")
    if size <= 0 or not sigma > 0:
        raise ValueError(f"size {size} and sigma {sigma} must be positive")
    out = np.empty((size, size, j.shape[1]), np.float32)
    lib = load_host_library("heatmap_splat")
    if lib.splat_heatmaps(j.ctypes.data, j.shape[0], j.shape[1], size, float(sigma), out.ctypes.data):
        raise ValueError(f"splat_heatmaps refused joints {j.shape}, size {size}, sigma {sigma}")
    return out


def rle_decode_native(counts, h: int, w: int) -> np.ndarray:
    """Run lengths (column-major, starting with zeros; int32) -> uint8
    ``[h, w]`` mask."""
    c = np.ascontiguousarray(counts, np.int32)
    if c.ndim != 1 or h < 0 or w < 0:
        raise ValueError(f"counts must be 1-D and h, w >= 0, got {c.shape}, {h}, {w}")
    out = np.empty((h, w), np.uint8)
    if load_host_library("rle_decode").rle_decode(c.ctypes.data, len(c), h, w, out.ctypes.data):
        raise ValueError(f"rle_decode refused {len(c)} counts at {h}x{w}")
    return out
