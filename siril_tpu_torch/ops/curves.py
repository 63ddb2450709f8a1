"""Curve transforms — counterpart of ``siril_tpu/ops/curves.py``
(``src/filters/curve_transform.c``): a natural cubic-spline or linear tone
curve through control points in [0, 1]², built as a dense table on the
host (``build_curve_lut``, numpy, copied) and applied on ``device`` by a
gather (``apply_curve``).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from siril_tpu_torch.core.image import SirilImage
from siril_tpu_torch.device import DeviceLike
from siril_tpu_torch.ops.stretch import finish, upload

CURVE_LINEAR = 0
CURVE_CUBIC = 1


def _natural_cubic_lut(xs: np.ndarray, ys: np.ndarray,
                       n: int = 4096) -> np.ndarray:
    """Natural cubic spline through the control points → dense LUT."""
    k = xs.size
    if k == 2:
        t = np.linspace(0.0, 1.0, n)
        return np.interp(t, xs, ys)
    h = np.diff(xs)
    # solve for second derivatives (natural boundary)
    A = np.zeros((k, k))
    b = np.zeros(k)
    A[0, 0] = A[-1, -1] = 1.0
    for i in range(1, k - 1):
        A[i, i - 1] = h[i - 1]
        A[i, i] = 2.0 * (h[i - 1] + h[i])
        A[i, i + 1] = h[i]
        b[i] = 3.0 * ((ys[i + 1] - ys[i]) / h[i]
                      - (ys[i] - ys[i - 1]) / h[i - 1])
    c = np.linalg.solve(A, b)
    bb = (np.diff(ys) / h) - h * (2.0 * c[:-1] + c[1:]) / 3.0
    dd = np.diff(c) / (3.0 * h)
    t = np.linspace(0.0, 1.0, n)
    seg = np.clip(np.searchsorted(xs, t, side="right") - 1, 0, k - 2)
    dt = t - xs[seg]
    lut = ys[seg] + bb[seg] * dt + c[seg] * dt ** 2 + dd[seg] * dt ** 3
    return np.clip(lut, 0.0, 1.0)


def build_curve_lut(points: Sequence[Tuple[float, float]],
                    algo: int = CURVE_CUBIC, n: int = 4096) -> np.ndarray:
    pts = sorted((float(x), float(y)) for x, y in points)
    if pts[0][0] > 0.0:
        pts.insert(0, (0.0, pts[0][1]))
    if pts[-1][0] < 1.0:
        pts.append((1.0, pts[-1][1]))
    xs = np.array([p[0] for p in pts])
    ys = np.array([p[1] for p in pts])
    if algo == CURVE_LINEAR or xs.size < 3:
        t = np.linspace(0.0, 1.0, n)
        return np.interp(t, xs, ys).astype(np.float32)
    return _natural_cubic_lut(xs, ys, n).astype(np.float32)


def apply_lut(d: torch.Tensor, lut: np.ndarray) -> torch.Tensor:
    """``lut`` at the truncated index d·(n−1) of every value of ``d``."""
    t = torch.from_numpy(lut).to(d.device)
    n = t.shape[0]
    return t[torch.clamp((d * (n - 1)).to(torch.int32), 0, n - 1).long()]


def apply_curve(img: SirilImage, points: Sequence[Tuple[float, float]],
                algo: int = CURVE_CUBIC, channels: Sequence[int] = None,
                device: DeviceLike = None) -> SirilImage:
    """Apply the tone curve to the selected channels (all by default)."""
    d = upload(img, device)
    mapped = apply_lut(d, build_curve_lut(points, algo))
    if channels is not None:
        keep = torch.zeros(img.nchans, dtype=torch.bool, device=d.device)
        keep[list(channels)] = True
        mapped = torch.where(keep[:, None, None], mapped, d)
    return finish(img, mapped, f"Curve transform ({len(points)} points)")
