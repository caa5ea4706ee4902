"""Object Keypoint Similarity (OKS) metrics (port of
human_pose_tpu/metrics/oks.py; cv2 imported where it is used).

Counterpart of reference src/keypoints/datasets/coco.py:484-535 (per-object /
per-image OKS with COCO k_i constants and segmentation-polygon areas) and the
greedy pred<->target matching of src/keypoints/results.py:21-43.
"""

from __future__ import annotations

import numpy as np

# COCO per-keypoint constants (reference coco.py:484-486)
K_I = np.array(
    [26, 25, 25, 35, 35, 79, 79, 72, 72, 62, 62, 107, 107, 87, 87, 89, 89],
    np.float64,
) / 1000.0
VARIANCES = (K_I * 2) ** 2


def polygons_area(polygons: list) -> float:
    import cv2

    return float(
        sum(
            cv2.contourArea(np.asarray(p, np.float64).reshape(-1, 2).astype(np.int32))
            for p in polygons
        )
    )


def object_OKS(
    pred_kpts: np.ndarray,
    target_kpts: np.ndarray,
    target_vis: np.ndarray,
    obj_polygons: list,
) -> float:
    """Per-object OKS (reference coco.py:489-514). Returns -1 when the target
    has no visible keypoints."""
    if target_vis.sum() <= 0:
        return -1.0
    vis = target_vis > 0
    area = polygons_area(obj_polygons) + np.spacing(1)
    dist_sq = ((pred_kpts - target_kpts) ** 2).sum(-1)
    e = dist_sq / (2 * VARIANCES * area)
    e = np.exp(-e[vis])
    return float(e.sum() / vis.sum())


def image_OKS(
    pred_kpts: np.ndarray,
    target_kpts: np.ndarray,
    target_vis: np.ndarray,
    seg_polygons: list,
) -> float:
    """Mean OKS over valid objects (reference coco.py:517-535)."""
    vals = np.array(
        [
            object_OKS(pred_kpts[j], target_kpts[j], target_vis[j], seg_polygons[j])
            for j in range(len(target_kpts))
        ]
    ).round(3)
    valid = vals != -1
    return float(vals[valid].mean()) if valid.sum() > 0 else -1.0


def match_preds_to_targets(
    pred_joints: np.ndarray,
    pred_scores: np.ndarray,
    target_kpts: np.ndarray,
    target_visibilities: np.ndarray,
) -> list[int]:
    """Greedy inverse-distance matching (reference results.py:21-43)."""
    num_targets = len(target_kpts)
    sorted_idxs = np.argsort(pred_scores, kind="mergesort")
    matches_idx = [-1] * num_targets
    matches_val = [-np.inf] * num_targets
    for pred_idx in sorted_idxs:
        p = pred_joints[pred_idx]
        for t in range(num_targets):
            vis = target_visibilities[t] > 0
            if vis.sum() == 0:
                continue
            d = (((p[..., :2] - target_kpts[t][..., :2])[vis]) ** 2).sum(-1).mean()
            val = 1.0 / d if d > 0 else np.inf
            if val > matches_val[t]:
                matches_val[t] = val
                matches_idx[t] = int(pred_idx)
    return matches_idx
