"""Image grid / drawing helpers (port of human_pose_tpu/utils/image.py;
cv2 imported where it is used)."""

from __future__ import annotations

import numpy as np

_PALETTE = np.array(
    [
        (31, 119, 180), (255, 127, 14), (44, 160, 44), (214, 39, 40),
        (148, 103, 189), (140, 86, 75), (227, 119, 194), (127, 127, 127),
        (188, 189, 34), (23, 190, 207), (255, 187, 120), (152, 223, 138),
        (255, 152, 150), (197, 176, 213), (196, 156, 148), (247, 182, 210),
    ],
    np.uint8,
)


def get_color(idx: int) -> np.ndarray:
    return _PALETTE[idx % len(_PALETTE)].copy()


def put_txt(
    image: np.ndarray,
    labels: list[str],
    position: tuple[int, int] = (10, 20),
    alpha: float = 1.0,
    font_scale: float = 0.5,
    color=(255, 255, 255),
) -> np.ndarray:
    import cv2

    overlay = image.copy()
    x, y = position
    for line in labels:
        cv2.putText(overlay, line, (x, y), cv2.FONT_HERSHEY_SIMPLEX, font_scale, (0, 0, 0), 3)
        cv2.putText(overlay, line, (x, y), cv2.FONT_HERSHEY_SIMPLEX, font_scale, color, 1)
        y += int(24 * font_scale / 0.5)
    cv2.addWeighted(overlay, alpha, image, 1 - alpha, 0, dst=image)
    return image


def make_grid(images: list[np.ndarray], nrows: int = 1, pad: int = 2, match_size: bool = False) -> np.ndarray:
    """Tile images into a grid of ``nrows`` rows."""
    import cv2

    if match_size:
        h = min(im.shape[0] for im in images)
        images = [
            cv2.resize(im, (int(im.shape[1] * h / im.shape[0]), h)) for im in images
        ]
    n = len(images)
    ncols = -(-n // nrows)
    cell_h = max(im.shape[0] for im in images) + pad * 2
    cell_w = max(im.shape[1] for im in images) + pad * 2
    grid = np.full((nrows * cell_h, ncols * cell_w, 3), 255, np.uint8)
    for i, im in enumerate(images):
        if im.ndim == 2:
            im = cv2.cvtColor(im, cv2.COLOR_GRAY2RGB)
        r, c = divmod(i, ncols)
        y0 = r * cell_h + pad
        x0 = c * cell_w + pad
        grid[y0 : y0 + im.shape[0], x0 : x0 + im.shape[1]] = im
    return grid


def stack_horizontally(images: list[np.ndarray], pad: int = 2) -> np.ndarray:
    import cv2

    h = max(im.shape[0] for im in images)
    parts = []
    for im in images:
        if im.ndim == 2:
            im = cv2.cvtColor(im, cv2.COLOR_GRAY2RGB)
        canvas = np.full((h, im.shape[1] + pad, 3), 255, np.uint8)
        canvas[: im.shape[0], : im.shape[1]] = im
        parts.append(canvas)
    return np.concatenate(parts, axis=1)


def match_size_to_src(src: np.ndarray, images: list[np.ndarray], mode: str = "height") -> list[np.ndarray]:
    import cv2

    out = []
    for im in images:
        if mode == "height":
            scale = src.shape[0] / im.shape[0]
        else:
            scale = src.shape[1] / im.shape[1]
        out.append(cv2.resize(im, (int(im.shape[1] * scale), int(im.shape[0] * scale))))
    return out
