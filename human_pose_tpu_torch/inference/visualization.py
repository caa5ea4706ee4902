"""Keypoints / classification visualization (port of
human_pose_tpu/inference/visualization.py; cv2 imported where it is used).

Counterpart of reference src/keypoints/visualization.py (plot_connections,
plot_heatmaps, plot_grouped_ae_tags) and src/classification/visualization.py
(top-5 overlay).
"""

from __future__ import annotations

import numpy as np

from ..utils.image import get_color, put_txt


def plot_connections(
    image: np.ndarray,
    kpts_coords: np.ndarray,
    scores: np.ndarray,
    limbs: list[tuple[int, int]],
    thr: float = 0.05,
    alpha: float = 0.8,
) -> np.ndarray:
    """Draw per-person limb connections. kpts_coords [P, K, 2] (x, y),
    scores [P, K] (or [P, K] visibility)."""
    import cv2

    overlay = image.copy()
    for p in range(len(kpts_coords)):
        color = get_color(p).tolist()
        kpts = kpts_coords[p]
        sc = scores[p]
        for a, b in limbs:
            if sc[a] > thr and sc[b] > thr:
                pa = tuple(np.round(kpts[a]).astype(int))
                pb = tuple(np.round(kpts[b]).astype(int))
                cv2.line(overlay, pa, pb, color, 2)
        for k in range(len(kpts)):
            if sc[k] > thr:
                cv2.circle(overlay, tuple(np.round(kpts[k]).astype(int)), 3, color, -1)
    return cv2.addWeighted(overlay, alpha, image, 1 - alpha, 0)


def plot_heatmaps(
    image: np.ndarray,
    heatmaps: np.ndarray,
    clip_0_1: bool = False,
    minmax: bool = False,
) -> list[np.ndarray]:
    """Per-channel colored heatmap overlays. heatmaps [H, W, K] or [K, H, W]
    is auto-detected by matching the image size."""
    import cv2

    if heatmaps.shape[:2] != image.shape[:2] and heatmaps.shape[1:3] == image.shape[:2]:
        heatmaps = np.moveaxis(heatmaps, 0, -1)
    h, w = image.shape[:2]
    out = []
    for k in range(heatmaps.shape[-1]):
        hm = heatmaps[..., k].astype(np.float32)
        if minmax:
            lo, hi = hm.min(), hm.max()
            hm = (hm - lo) / (hi - lo + 1e-9)
        if clip_0_1:
            hm = np.clip(hm, 0, 1)
        hm8 = (hm * 255).astype(np.uint8)
        if hm8.shape[:2] != (h, w):
            hm8 = cv2.resize(hm8, (w, h))
        colored = cv2.applyColorMap(hm8, cv2.COLORMAP_JET)
        colored = cv2.cvtColor(colored, cv2.COLOR_BGR2RGB)
        out.append(cv2.addWeighted(colored, 0.6, image, 0.4, 0))
    return out


def plot_grouped_ae_tags(kpts_tags: np.ndarray, size: int = 400) -> np.ndarray:
    """Scatter of tag values per person x joint (reference AE plot)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    p, k = kpts_tags.shape[:2]
    fig, ax = plt.subplots(figsize=(4, 4), dpi=size // 4)
    for i in range(p):
        tags = kpts_tags[i, :, 0] if kpts_tags.ndim == 3 else kpts_tags[i]
        c = get_color(i) / 255.0
        ax.scatter(np.arange(k), tags, color=c, s=12, label=f"person {i}")
    ax.set_xlabel("joint")
    ax.set_ylabel("tag value")
    ax.grid(alpha=0.3)
    fig.tight_layout()
    fig.canvas.draw()
    img = np.asarray(fig.canvas.buffer_rgba())[..., :3].copy()
    plt.close(fig)
    return img


def plot_top_probs(
    image: np.ndarray, probs: np.ndarray, labels: list[str], k: int = 5
) -> np.ndarray:
    """Top-k class probability overlay (reference classification results)."""
    top = np.argsort(-probs)[:k]
    lines = [f"{labels[i] if i < len(labels) else i}: {probs[i]:.3f}" for i in top]
    out = image.copy()
    put_txt(out, lines, alpha=0.85, font_scale=0.5)
    return out
