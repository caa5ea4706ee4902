"""Interactive HTML metric plots with zero dependencies (port of
human_pose_tpu/train/html_plots.py; the same bytes for the same storage).

Counterpart of the reference's plotly outputs (src/base/visualization.py:45-127
``plot_metrics_plotly`` / ``plot_system_monitoring``; saved by the metrics
callback next to the matplotlib jpg, src/base/callbacks.py:258-282). The
plotly package is absent from this image, so the same capability — an
interactive, self-contained HTML file with hover read-outs and series
toggling — is produced directly: inline SVG charts plus ~60 lines of vanilla
JS (nearest-point tooltip, crosshair, click-to-hide legend). No CDN, no
external assets; the file is fully viewable offline.
"""

from __future__ import annotations

import html
import json
import math
from pathlib import Path

from .storage import MetricsStorage, SystemMonitoringStorage

# T10-like categorical palette (distinct hues, color-blind friendly order)
_PALETTE = [
    "#4c78a8", "#f58518", "#e45756", "#72b7b2", "#54a24b",
    "#eeca3b", "#b279a2", "#ff9da6", "#9d755d", "#bab0ac",
]

_W, _H = 560, 360  # per-panel SVG size
_ML, _MR, _MT, _MB = 58, 14, 30, 38  # margins: left/right/top/bottom

_JS = """
(function(){
  document.querySelectorAll('.panel').forEach(function(panel){
    var svg = panel.querySelector('svg');
    var data = JSON.parse(panel.querySelector('script.data').textContent);
    var tip = panel.querySelector('.tip');
    var cross = panel.querySelector('.cross');
    var hidden = {};
    panel.querySelectorAll('.leg').forEach(function(leg){
      leg.addEventListener('click', function(){
        var s = leg.getAttribute('data-s');
        hidden[s] = !hidden[s];
        leg.style.opacity = hidden[s] ? 0.3 : 1.0;
        svg.querySelectorAll('[data-s="'+s+'"]').forEach(function(el){
          el.style.display = hidden[s] ? 'none' : '';
        });
      });
    });
    svg.addEventListener('mousemove', function(ev){
      var r = svg.getBoundingClientRect();
      var mx = (ev.clientX - r.left) * (svg.viewBox.baseVal.width / r.width);
      var my = (ev.clientY - r.top) * (svg.viewBox.baseVal.height / r.height);
      var best = null, bd = 1e18;
      data.series.forEach(function(s){
        if (hidden[s.name]) return;
        s.px.forEach(function(p, i){
          var d = (p[0]-mx)*(p[0]-mx) + (p[1]-my)*(p[1]-my);
          if (d < bd) { bd = d; best = {s: s, i: i, p: p}; }
        });
      });
      if (!best || bd > 60*60) { tip.style.display='none'; cross.style.display='none'; return; }
      cross.setAttribute('cx', best.p[0]); cross.setAttribute('cy', best.p[1]);
      cross.setAttribute('stroke', best.s.color); cross.style.display='';
      tip.style.display='';
      tip.textContent = best.s.name + '  ' + data.xlabel + '=' + best.s.xs[best.i] +
        '  value=' + Number(best.s.ys[best.i]).toPrecision(6);
    });
    svg.addEventListener('mouseleave', function(){
      tip.style.display='none'; cross.style.display='none';
    });
  });
})();
"""


def _ticks(lo: float, hi: float, n: int = 5) -> list[float]:
    if not math.isfinite(lo) or not math.isfinite(hi):
        return [0.0]
    if hi <= lo:
        hi = lo + 1.0
    raw = (hi - lo) / n
    mag = 10 ** math.floor(math.log10(raw))
    step = min(s for s in (1 * mag, 2 * mag, 5 * mag, 10 * mag) if s >= raw)
    t0 = math.ceil(lo / step) * step
    out = []
    t = t0
    while t <= hi + 1e-12 * step:
        out.append(round(t, 12))
        t += step
    return out or [lo]


def _fmt(v: float) -> str:
    if v == 0:
        return "0"
    if abs(v) >= 1e4 or abs(v) < 1e-3:
        return f"{v:.2e}"
    return f"{v:g}"


def _panel_svg(title: str, xlabel: str, series: list[dict]) -> str:
    """One SVG chart: series = [{name, xs, ys, color}]."""
    all_x = [x for s in series for x in s["xs"]]
    all_y = [y for s in series for y in s["ys"] if math.isfinite(y)]
    if not all_x or not all_y:
        return ""
    x_lo, x_hi = min(all_x), max(all_x)
    y_lo, y_hi = min(all_y), max(all_y)
    if x_hi == x_lo:
        x_hi = x_lo + 1
    if y_hi == y_lo:
        y_hi = y_lo + (abs(y_lo) or 1) * 0.1
    pad = (y_hi - y_lo) * 0.06
    y_lo, y_hi = y_lo - pad, y_hi + pad

    def sx(x):
        return _ML + (x - x_lo) / (x_hi - x_lo) * (_W - _ML - _MR)

    def sy(y):
        return _H - _MB - (y - y_lo) / (y_hi - y_lo) * (_H - _MT - _MB)

    parts = [
        f'<svg viewBox="0 0 {_W} {_H}" width="{_W}" height="{_H}" '
        'style="font-family:sans-serif">',
        f'<text x="{_ML}" y="18" font-size="14" font-weight="bold">'
        f"{html.escape(title)}</text>",
        f'<rect x="{_ML}" y="{_MT}" width="{_W - _ML - _MR}" '
        f'height="{_H - _MT - _MB}" fill="#fafafa" stroke="#ddd"/>',
    ]
    for t in _ticks(x_lo, x_hi):
        if x_lo <= t <= x_hi:
            x = sx(t)
            parts.append(
                f'<line x1="{x:.1f}" y1="{_MT}" x2="{x:.1f}" y2="{_H - _MB}" '
                'stroke="#e5e5e5"/>'
                f'<text x="{x:.1f}" y="{_H - _MB + 16}" font-size="10" '
                f'text-anchor="middle" fill="#555">{_fmt(t)}</text>'
            )
    for t in _ticks(y_lo, y_hi):
        if y_lo <= t <= y_hi:
            y = sy(t)
            parts.append(
                f'<line x1="{_ML}" y1="{y:.1f}" x2="{_W - _MR}" y2="{y:.1f}" '
                'stroke="#e5e5e5"/>'
                f'<text x="{_ML - 6}" y="{y + 3:.1f}" font-size="10" '
                f'text-anchor="end" fill="#555">{_fmt(t)}</text>'
            )
    parts.append(
        f'<text x="{(_ML + _W - _MR) / 2:.0f}" y="{_H - 6}" font-size="11" '
        f'text-anchor="middle" fill="#333">{html.escape(xlabel)}</text>'
    )
    data = {"xlabel": xlabel, "series": []}
    for s in series:
        pts = [(sx(x), sy(y)) for x, y in zip(s["xs"], s["ys"]) if math.isfinite(y)]
        if not pts:
            continue
        name = html.escape(s["name"], quote=True)
        path = "M" + " L".join(f"{x:.1f} {y:.1f}" for x, y in pts)
        parts.append(
            f'<path d="{path}" fill="none" stroke="{s["color"]}" '
            f'stroke-width="1.6" data-s="{name}"/>'
        )
        if len(pts) <= 200:
            dots = "".join(
                f'<circle cx="{x:.1f}" cy="{y:.1f}" r="2.2" fill="{s["color"]}"/>'
                for x, y in pts
            )
            parts.append(f'<g data-s="{name}">{dots}</g>')
        data["series"].append(
            {
                "name": s["name"],
                "color": s["color"],
                "xs": s["xs"],
                "ys": s["ys"],
                "px": [[round(x, 1), round(y, 1)] for x, y in pts],
            }
        )
    parts.append(
        '<circle class="cross" r="5" fill="none" stroke-width="2" '
        'style="display:none" cx="0" cy="0"/>'
    )
    parts.append("</svg>")
    legend = "".join(
        f'<span class="leg" data-s="{html.escape(s["name"], quote=True)}" '
        f'style="cursor:pointer;margin-right:12px;font:12px sans-serif">'
        f'<span style="color:{s["color"]}">&#9632;</span> '
        f"{html.escape(s['name'])}</span>"
        for s in series
    )
    return (
        '<div class="panel" style="display:inline-block;margin:8px;'
        'vertical-align:top">'
        + "".join(parts)
        + f'<div>{legend}</div><div class="tip" style="display:none;'
        'font:12px monospace;background:#222;color:#fff;padding:2px 6px;'
        'border-radius:3px;width:fit-content"></div>'
        f'<script class="data" type="application/json">{json.dumps(data)}</script>'
        "</div>"
    )


def _write(filepath: str | Path, title: str, panels: list[str]) -> None:
    panels = [p for p in panels if p]
    if not panels:
        return
    doc = (
        "<!DOCTYPE html><html><head><meta charset='utf-8'>"
        f"<title>{html.escape(title)}</title></head><body>"
        + "".join(panels)
        + f"<script>{_JS}</script></body></html>"
    )
    path = Path(filepath)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(doc)


def plot_metrics_html(
    storage: MetricsStorage, filepath: str | Path, step_key: str = "epoch"
) -> None:
    """One interactive panel per metric, one line per split (reference
    plot_metrics_plotly, src/base/visualization.py:45)."""
    panels = []
    for name, splits in storage.metrics.items():
        series = []
        for i, (split, records) in enumerate(splits.items()):
            if "sanity" in split:
                continue
            series.append(
                {
                    "name": split,
                    "color": _PALETTE[i % len(_PALETTE)],
                    "xs": [r[step_key] for r in records],
                    "ys": [r["value"] for r in records],
                }
            )
        if series:
            panels.append(_panel_svg(name, step_key, series))
    _write(filepath, storage.name, panels)


def plot_system_monitoring_html(
    storage: SystemMonitoringStorage, filepath: str | Path
) -> None:
    """Interactive system-metrics time series (reference
    plot_system_monitoring, src/base/visualization.py:127)."""
    data = storage.to_dict()
    ts = data.pop("timestamp", None)
    if not data or ts is None:
        return
    t0 = ts[0]
    xs = [round(t - t0, 2) for t in ts]
    panels = [
        _panel_svg(
            name,
            "seconds",
            [{"name": name, "color": _PALETTE[i % len(_PALETTE)], "xs": xs, "ys": ys}],
        )
        for i, (name, ys) in enumerate(data.items())
    ]
    _write(filepath, "system monitoring", panels)
