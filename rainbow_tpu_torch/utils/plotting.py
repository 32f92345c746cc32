"""Self-contained HTML/SVG line plots of metric populations over steps.

Replaces the reference's plotly offline plots (reference test.py:62-78):
same semantics — min/max dashed lines, mean line, ±1 std shaded band over the
per-evaluation population — but emitted as a dependency-free standalone HTML
file (this image ships no plotly). Written to results/<id>/{Reward,Q}.html
like the reference.
"""
from __future__ import annotations

import os
from typing import List, Sequence

import numpy as np

_W, _H = 900, 450
_M = 60  # margin


def _polyline(xs, ys, color, dash="", width=2):
    pts = " ".join(f"{x:.1f},{y:.1f}" for x, y in zip(xs, ys))
    d = f' stroke-dasharray="6,4"' if dash else ""
    return (f'<polyline fill="none" stroke="{color}" stroke-width="{width}"'
            f'{d} points="{pts}"/>')


def plot_line(xs: Sequence[float], ys_population: List[Sequence[float]],
              title: str, path: str) -> str:
    """xs: eval steps; ys_population[i]: population of values at xs[i]."""
    ys = [np.asarray(p, np.float64) for p in ys_population]
    mean = np.array([p.mean() for p in ys])
    # population std with ddof=1 like torch.std (reference test.py:66)
    std = np.array([p.std(ddof=1) if len(p) > 1 else 0.0 for p in ys])
    lo, hi = np.array([p.min() for p in ys]), np.array([p.max() for p in ys])
    xs = np.asarray(xs, np.float64)

    x0, x1 = (xs.min(), xs.max()) if len(xs) > 1 else (xs[0] - 1, xs[0] + 1)
    ymin = min(lo.min(), (mean - std).min())
    ymax = max(hi.max(), (mean + std).max())
    if ymax == ymin:
        ymax = ymin + 1
    pad = 0.05 * (ymax - ymin)
    ymin, ymax = ymin - pad, ymax + pad

    def sx(v):
        return _M + (v - x0) / (x1 - x0 + 1e-12) * (_W - 2 * _M)

    def sy(v):
        return _H - _M - (v - ymin) / (ymax - ymin) * (_H - 2 * _M)

    px = [sx(v) for v in xs]
    band_pts = (" ".join(f"{x:.1f},{sy(m + s):.1f}"
                         for x, m, s in zip(px, mean, std)) + " " +
                " ".join(f"{x:.1f},{sy(m - s):.1f}"
                         for x, m, s in zip(px[::-1], mean[::-1], std[::-1])))
    # axis ticks
    ticks = []
    for i in range(6):
        yv = ymin + i * (ymax - ymin) / 5
        ticks.append(f'<line x1="{_M}" y1="{sy(yv):.1f}" x2="{_W-_M}" '
                     f'y2="{sy(yv):.1f}" stroke="#eee"/>'
                     f'<text x="{_M-8}" y="{sy(yv)+4:.1f}" text-anchor="end" '
                     f'font-size="11" fill="#666">{yv:.3g}</text>')
        xv = x0 + i * (x1 - x0) / 5
        ticks.append(f'<text x="{sx(xv):.1f}" y="{_H-_M+18}" '
                     f'text-anchor="middle" font-size="11" fill="#666">'
                     f'{xv:.4g}</text>')

    svg = f"""<svg xmlns="http://www.w3.org/2000/svg" width="{_W}" height="{_H}">
<rect width="100%" height="100%" fill="white"/>
{''.join(ticks)}
<polygon points="{band_pts}" fill="rgba(29,202,255,0.2)" stroke="none"/>
{_polyline(px, [sy(v) for v in hi], "rgb(0,132,180)", dash="1")}
{_polyline(px, [sy(v) for v in lo], "rgb(0,132,180)", dash="1")}
{_polyline(px, [sy(v) for v in mean], "rgb(0,172,237)")}
<text x="{_W/2}" y="24" text-anchor="middle" font-size="16">{title}</text>
<text x="{_W/2}" y="{_H-14}" text-anchor="middle" font-size="12" fill="#444">Step</text>
</svg>"""
    html = (f"<!DOCTYPE html><html><head><meta charset='utf-8'>"
            f"<title>{title}</title></head><body>{svg}</body></html>")
    out = os.path.join(path, f"{title}.html")
    os.makedirs(path, exist_ok=True)
    with open(out, "w") as f:
        f.write(html)
    return out
