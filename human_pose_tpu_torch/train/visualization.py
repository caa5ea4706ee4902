"""Metric and system-monitoring plots as jpgs, drawn with cv2 (port of
human_pose_tpu/train/visualization.py).

The JAX package draws them with matplotlib, which the card's machine does not
have; cv2 is on both. Each metric gets a panel with one polyline per split,
its name, the x axis' key and the value range; the html beside each jpg
(``train/html_plots.py``) carries the data. Counterpart of reference
src/base/visualization.py.
"""

from __future__ import annotations

from pathlib import Path

import cv2
import numpy as np

from .storage import MetricsStorage, SystemMonitoringStorage

# BGR, the html plots' palette
_PALETTE = [(168, 120, 76), (24, 133, 245), (86, 87, 228), (178, 183, 114), (75, 162, 84),
            (59, 202, 238), (162, 121, 178), (166, 157, 255), (93, 117, 157), (172, 176, 186)]
_W, _H = 480, 320  # panel size
_ML, _MR, _MT, _MB = 70, 16, 34, 40  # margins: left, right, top, bottom
_FONT = cv2.FONT_HERSHEY_SIMPLEX


def _text(img, text: str, org, scale: float = 0.45, color=(40, 40, 40)) -> None:
    cv2.putText(img, text, (int(org[0]), int(org[1])), _FONT, scale, color, 1, cv2.LINE_AA)


def _panel(title: str, series: dict[str, tuple[list, list]], xlabel: str) -> np.ndarray:
    """One panel: ``series`` maps a name to (xs, ys); axes, tick labels at
    the ends of each range, the title, the x label and a legend."""
    img = np.full((_H, _W, 3), 255, np.uint8)
    x0, x1, y0, y1 = _ML, _W - _MR, _MT, _H - _MB
    cv2.rectangle(img, (x0, y0), (x1, y1), (200, 200, 200), 1)
    _text(img, title, (x0, 22), 0.55)
    _text(img, xlabel, ((x0 + x1) / 2 - 20, _H - 8))
    pts = [(x, y) for xs, ys in series.values() for x, y in zip(xs, ys)
           if np.isfinite(x) and np.isfinite(y)]
    if not pts:
        return img
    xs_all, ys_all = zip(*pts)
    xmin, xmax, ymin, ymax = min(xs_all), max(xs_all), min(ys_all), max(ys_all)
    if xmax == xmin:
        xmin, xmax = xmin - 0.5, xmax + 0.5
    if ymax == ymin:
        pad = abs(ymin) * 0.05 or 0.5
        ymin, ymax = ymin - pad, ymax + pad

    def to_px(x, y):
        return (x0 + (x - xmin) / (xmax - xmin) * (x1 - x0), y1 - (y - ymin) / (ymax - ymin) * (y1 - y0))

    _text(img, f"{xmin:.4g}", (x0, y1 + 16), 0.4)
    _text(img, f"{xmax:.4g}", (x1 - 40, y1 + 16), 0.4)
    _text(img, f"{ymax:.4g}", (4, y0 + 10), 0.4)
    _text(img, f"{ymin:.4g}", (4, y1), 0.4)
    for i, (name, (xs, ys)) in enumerate(series.items()):
        color = _PALETTE[i % len(_PALETTE)]
        line = np.array([to_px(x, y) for x, y in zip(xs, ys) if np.isfinite(x) and np.isfinite(y)])
        if len(line):
            cv2.polylines(img, [np.round(line).astype(np.int32)], False, color, 2, cv2.LINE_AA)
            if len(line) < 50:
                for p in np.round(line).astype(np.int32):
                    cv2.circle(img, (int(p[0]), int(p[1])), 3, color, -1, cv2.LINE_AA)
        _text(img, name, (x1 - 90, y0 + 16 + 16 * i), 0.45, color)
    return img


def _grid(panels: list, ncols: int) -> np.ndarray:
    nrows = -(-len(panels) // ncols)
    blank = np.full((_H, _W, 3), 255, np.uint8)
    panels = panels + [blank] * (nrows * ncols - len(panels))
    return np.vstack([np.hstack(panels[r * ncols:(r + 1) * ncols]) for r in range(nrows)])


def _save(img: np.ndarray, filepath: str | Path) -> None:
    Path(filepath).parent.mkdir(parents=True, exist_ok=True)
    if not cv2.imwrite(str(filepath), img):
        raise OSError(f"cv2 could not write {filepath}")


def plot_metrics(storage: MetricsStorage, filepath: str | Path, step_key: str = "epoch") -> None:
    names = list(storage.metrics.keys())
    if not names:
        return
    panels = [
        _panel(name, {split: ([r[step_key] for r in records], [r["value"] for r in records])
                      for split, records in storage.metrics[name].items()}, step_key)
        for name in names
    ]
    _save(_grid(panels, min(3, len(names))), filepath)


def plot_system_monitoring(storage: SystemMonitoringStorage, filepath: str | Path) -> None:
    data = storage.to_dict()
    ts = data.pop("timestamp", None)
    if not data or ts is None:
        return
    xs = [t - ts[0] for t in ts]
    panels = [_panel(name, {name: (xs, values)}, "seconds") for name, values in data.items()]
    _save(_grid(panels, 3), filepath)
