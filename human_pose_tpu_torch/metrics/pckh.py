"""PCKh metric for MPII-style evaluation (port of
human_pose_tpu/metrics/pckh.py; reference src/keypoints/datasets/mpii.py:6-53):
a predicted keypoint is correct when its distance to the target is at most
``thr`` times the head-segment length."""

from __future__ import annotations

import numpy as np

MPII_HEAD_IDXS = (9, 8)  # head top, upper neck


def pckh(
    pred_kpts: np.ndarray,
    target_kpts: np.ndarray,
    target_vis: np.ndarray,
    head_idxs=MPII_HEAD_IDXS,
    thr: float = 0.5,
) -> float:
    """pred/target ``[num_obj, K, 2]``, vis ``[num_obj, K]``: the share of
    visible joints within ``thr`` head lengths (objects with a zero head
    length skipped), -1.0 when no joint counts."""
    correct, total = 0, 0
    for p, t, v in zip(pred_kpts, target_kpts, target_vis):
        head_len = np.linalg.norm(t[head_idxs[0]] - t[head_idxs[1]])
        if head_len <= 0:
            continue
        vis = v > 0
        d = np.linalg.norm(p - t, axis=-1)
        correct += int((d[vis] <= thr * head_len).sum())
        total += int(vis.sum())
    return correct / total if total else -1.0
