"""Plot surface — counterpart of ``siril_tpu/utils/splot.py``
(``SirilPlot``:37, ``save_dat``:73, ``save_png``:98; the reference's
``src/io/siril_plot.c``).

A small PIL rasterizer draws the same headless outputs as the JAX
package's, pixel for pixel: multi-series XY line / point plots with
error bars, axes, ticks, legend and title, saved as PNG and ``.dat``.
PIL is imported when a PNG is drawn; without it ``save_png`` raises.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import numpy as np

_COLORS = [(204, 51, 51), (51, 102, 204), (51, 153, 51), (204, 153, 0),
           (153, 51, 204), (0, 153, 153)]


@dataclass
class _Series:
    label: str
    x: np.ndarray
    y: np.ndarray
    errp: Optional[np.ndarray] = None
    errm: Optional[np.ndarray] = None
    kind: str = "linespoints"            # line | points | linespoints


@dataclass
class SirilPlot:
    """siril_plot_data equivalent."""

    title: str = ""
    xlabel: str = ""
    ylabel: str = ""
    revertX: bool = False
    revertY: bool = False
    series: List[_Series] = field(default_factory=list)

    def add_xydata(self, label: str, x: Sequence[float],
                   y: Sequence[float], kind: str = "linespoints") -> None:
        self.series.append(_Series(label, np.asarray(x, float),
                                   np.asarray(y, float), kind=kind))

    def add_xyerrdata(self, label: str, x: Sequence[float],
                      y: Sequence[float], errp: Sequence[float],
                      errm: Optional[Sequence[float]] = None,
                      kind: str = "points") -> None:
        ep = np.asarray(errp, float)
        em = ep if errm is None else np.asarray(errm, float)
        self.series.append(_Series(label, np.asarray(x, float),
                                   np.asarray(y, float), ep, em, kind))

    def sort_x(self) -> None:
        """siril_plot_sort_x."""
        for s in self.series:
            order = np.argsort(s.x)
            s.x = s.x[order]
            s.y = s.y[order]
            if s.errp is not None:
                s.errp = s.errp[order]
                s.errm = s.errm[order]

    # ------------------------------------------------------------------
    def save_dat(self, path: str) -> None:
        """siril_plot_save_dat: per-series x y [err] column groups —
        series may have different lengths and x grids, so each carries
        its own x column (short series pad with 'nan')."""
        with open(path, "w") as f:
            hdr = []
            for i, s in enumerate(self.series):
                lab = (s.label or f"series{i}").replace(" ", "_")
                hdr += [f"x_{lab}", f"y_{lab}"]
                if s.errp is not None:
                    hdr.append(f"err_{lab}")
            f.write("# " + " ".join(hdr) + "\n")
            n = max((len(s.x) for s in self.series), default=0)
            for i in range(n):
                row = []
                for s in self.series:
                    if i < len(s.x):
                        row += [f"{s.x[i]:.8g}", f"{s.y[i]:.8g}"]
                        if s.errp is not None:
                            row.append(f"{s.errp[i]:.8g}")
                    else:
                        row += ["nan"] * (3 if s.errp is not None else 2)
                f.write(" ".join(row) + "\n")

    def save_png(self, path: str, width: int = 800, height: int = 600
                 ) -> None:
        """siril_plot_save_png: rasterize via PIL."""
        from PIL import Image, ImageDraw

        img = Image.new("RGB", (width, height), (255, 255, 255))
        dr = ImageDraw.Draw(img)
        ml, mr, mt, mb = 70, 20, 40 if self.title else 20, 50
        pw, ph = width - ml - mr, height - mt - mb

        xs = np.concatenate([s.x for s in self.series]) if self.series \
            else np.array([0.0, 1.0])
        ys_all = []
        for s in self.series:
            ys_all.append(s.y + (s.errp if s.errp is not None else 0))
            ys_all.append(s.y - (s.errm if s.errm is not None else 0))
        ys = np.concatenate(ys_all) if ys_all else np.array([0.0, 1.0])
        xs = xs[np.isfinite(xs)]
        ys = ys[np.isfinite(ys)]
        x0, x1 = (float(xs.min()), float(xs.max())) if xs.size else (0, 1)
        y0, y1 = (float(ys.min()), float(ys.max())) if ys.size else (0, 1)
        if x1 == x0:
            x1 = x0 + 1
        if y1 == y0:
            y1 = y0 + 1
        padx = 0.04 * (x1 - x0)
        pady = 0.07 * (y1 - y0)
        x0, x1 = x0 - padx, x1 + padx
        y0, y1 = y0 - pady, y1 + pady

        def px(x, y):
            fx = (x - x0) / (x1 - x0)
            fy = (y - y0) / (y1 - y0)
            if self.revertX:
                fx = 1.0 - fx
            if not self.revertY:
                fy = 1.0 - fy
            return ml + fx * pw, mt + fy * ph

        # frame + ticks
        dr.rectangle([ml, mt, ml + pw, mt + ph], outline=(0, 0, 0))
        for t in _ticks(x0, x1):
            tx, _ = px(t, y0)
            dr.line([tx, mt + ph, tx, mt + ph + 4], fill=(0, 0, 0))
            dr.text((tx - 10, mt + ph + 6), _fmt(t), fill=(0, 0, 0))
        for t in _ticks(y0, y1):
            _, ty = px(x0, t)
            dr.line([ml - 4, ty, ml, ty], fill=(0, 0, 0))
            dr.text((4, ty - 5), _fmt(t), fill=(0, 0, 0))
        if self.title:
            dr.text((width / 2 - 4 * len(self.title), 10), self.title,
                    fill=(0, 0, 0))
        if self.xlabel:
            dr.text((ml + pw / 2 - 3 * len(self.xlabel), height - 16),
                    self.xlabel, fill=(0, 0, 0))
        if self.ylabel:
            dr.text((4, mt - 14), self.ylabel, fill=(0, 0, 0))

        for i, s in enumerate(self.series):
            col = _COLORS[i % len(_COLORS)]
            pts = [px(x, y) for x, y in zip(s.x, s.y)
                   if math.isfinite(x) and math.isfinite(y)]
            if s.kind in ("line", "linespoints") and len(pts) > 1:
                dr.line(pts, fill=col, width=1)
            if s.kind in ("points", "linespoints"):
                for (cx, cy) in pts:
                    dr.ellipse([cx - 2, cy - 2, cx + 2, cy + 2], fill=col)
            if s.errp is not None:
                for x, y, ep, em in zip(s.x, s.y, s.errp, s.errm):
                    if not (math.isfinite(y) and math.isfinite(ep)):
                        continue
                    xa, ya = px(x, y + ep)
                    xb, yb = px(x, y - em)
                    dr.line([xa, ya, xb, yb], fill=col)
            if s.label:
                ly = mt + 6 + 14 * i
                dr.line([ml + pw - 60, ly + 5, ml + pw - 45, ly + 5],
                        fill=col, width=2)
                dr.text((ml + pw - 42, ly), s.label, fill=(0, 0, 0))
        img.save(path)


def _ticks(lo: float, hi: float, n: int = 6) -> List[float]:
    span = hi - lo
    step = 10 ** math.floor(math.log10(span / max(n, 1)))
    for m in (1, 2, 5, 10):
        if span / (step * m) <= n:
            step *= m
            break
    first = math.ceil(lo / step) * step
    out = []
    t = first
    while t <= hi + 1e-12 * span:
        out.append(round(t, 12))
        t += step
    return out


def _fmt(v: float) -> str:
    if v == int(v) and abs(v) < 1e6:
        return str(int(v))
    return f"{v:.4g}"
