"""Training targets for bottom-up pose: Gaussian heatmaps and padded joint
arrays (port of human_pose_tpu/data/targets.py; NumPy, host side).

* ``HeatmapGenerator``: a windowed 2-D Gaussian splat combined by max; the
  window is ``6*sigma+3`` wide, centred at ``(3*sigma+1, 3*sigma+1)``;
  joints off the map or with vis <= 0 are skipped. Channel-last
  ``[H, W, K]`` float32. ``__call__`` runs the native splat
  (``data/native.py``), as the JAX package's dataset does; ``plain`` is the
  NumPy loop, its plain version.
* ``JointsGenerator``: valid joints as integer ``(x, y, 1)``, persons
  without any dropped, padded to ``[max_num_people, K, 3]`` int32.
"""

from __future__ import annotations

import threading

import numpy as np

from .native import splat_heatmaps_native


class HeatmapGenerator:
    def __init__(self, num_kpts: int, size: int, sigma: float = 2.0):
        self.num_kpts = num_kpts
        self.h = self.w = size
        if sigma < 0:
            sigma = size / 64
        self.sigma = sigma
        span = np.arange(0, 6 * sigma + 3, 1, float)
        x0 = y0 = 3 * sigma + 1
        self.gauss = np.exp(
            -((span[None, :] - x0) ** 2 + (span[:, None] - y0) ** 2) / (2 * sigma**2)
        )
        # calls of the native splat (read by the chip smoke to show the
        # dataset's targets went through it); the loader's threads share it
        self.native_calls = 0
        self._lock = threading.Lock()

    def __call__(self, joints: np.ndarray) -> np.ndarray:
        """joints: ``[num_people, K, 3]`` (x, y, vis). Returns ``[H, W, K]``
        float32 from the native splat."""
        joints = np.asarray(joints, np.int32).reshape(-1, self.num_kpts, 3)
        out = splat_heatmaps_native(joints, self.h, self.sigma)
        with self._lock:
            self.native_calls += 1
        return out

    def plain(self, joints: np.ndarray) -> np.ndarray:
        """The NumPy loop of the JAX package's generator: the native splat's
        plain version."""
        hms = np.zeros((self.h, self.w, self.num_kpts), dtype=np.float32)
        s = self.sigma
        for person in joints:
            for idx in range(self.num_kpts):
                x, y, vis = person[idx]
                if vis <= 0 or x < 0 or y < 0 or x >= self.w or y >= self.h:
                    continue
                xmin = int(np.round(x - 3 * s - 1))
                ymin = int(np.round(y - 3 * s - 1))
                xmax = int(np.round(x + 3 * s + 2))
                ymax = int(np.round(y + 3 * s + 2))
                # clip the gaussian window against the map
                gx0, gx1 = max(0, -xmin), min(xmax, self.w) - xmin
                gy0, gy1 = max(0, -ymin), min(ymax, self.h) - ymin
                mx0, mx1 = max(0, xmin), min(xmax, self.w)
                my0, my1 = max(0, ymin), min(ymax, self.h)
                hms[my0:my1, mx0:mx1, idx] = np.maximum(
                    hms[my0:my1, mx0:mx1, idx], self.gauss[gy0:gy1, gx0:gx1]
                )
        return hms


class JointsGenerator:
    def __init__(self, size: int, max_num_people: int = 30):
        self.h = self.w = size
        self.max_num_people = max_num_people

    def __call__(self, joints: np.ndarray) -> np.ndarray:
        """joints: ``[num_people, K, 3]`` float. Returns ``[max_num_people,
        K, 3]`` int32 with invalid joints zeroed and empty persons dropped."""
        num_people, k = joints.shape[:2]
        out = np.zeros((num_people, k, 3), np.int32)
        for i in range(num_people):
            for j in range(k):
                x, y, vis = int(joints[i, j, 0]), int(joints[i, j, 1]), joints[i, j, 2]
                if vis > 0 and 0 <= x < self.w and 0 <= y < self.h:
                    out[i, j] = (x, y, 1)
        keep = out.sum(axis=(1, 2)) > 0
        out = out[keep][: self.max_num_people]
        padded = np.zeros((self.max_num_people, k, 3), np.int32)
        padded[: len(out)] = out
        return padded
