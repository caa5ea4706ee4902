"""The native heatmap splat (port of the splat of human_pose_tpu/data/native.py).

``csrc/heatmap_splat.cpp`` is the port's own copy of the JAX package's C++
splat (``native/hp_native.cpp``) behind a plain C interface. It is built
with the host C++ compiler at first use (``ops/_build.py``) and called
through ``ctypes``, which releases the GIL for the call, so the loader's
worker threads splat in parallel. There is no silent fallback: a failed
build raises with the compiler's output. The NumPy loop of
``data/targets.py`` (``HeatmapGenerator.plain``) is the plain version.
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
