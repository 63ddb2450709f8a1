"""Robust trend fitting — counterpart of ``siril_tpu/ops/fitting.py``
(``poly_fit``:21, ``siegel_fit``:28, ``robust_poly_fit``:49,
``find_linear_coeff``:75), host numpy copied; reference
``src/algos/fitting.c``:
least-squares polynomial fit (``fitting.c:65``), Siegel repeated-median
linear estimator (``fitting.c:112``), and the linear-match coefficient
solver (``find_linear_coeff``, ``fitting.c:325``).

Vectorized numpy: the Siegel estimator's O(n²) pairwise slopes are one
broadcasted matrix, not a double loop.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def poly_fit(x: np.ndarray, y: np.ndarray, degree: int = 1) -> np.ndarray:
    """Least-squares polynomial coefficients, constant term first."""
    V = np.vander(np.asarray(x, np.float64), degree + 1, increasing=True)
    coef, *_ = np.linalg.lstsq(V, np.asarray(y, np.float64), rcond=None)
    return coef


def siegel_fit(x: np.ndarray, y: np.ndarray) -> Tuple[float, float]:
    """Siegel repeated-median line (slope, intercept): for each point the
    median of its pairwise slopes, then the median over points — 50%
    breakdown, the reference's robust trend estimator."""
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    n = x.size
    if n < 2:
        return 0.0, float(y[0]) if n else 0.0
    dx = x[:, None] - x[None, :]
    dy = y[:, None] - y[None, :]
    with np.errstate(divide="ignore", invalid="ignore"):
        slopes = dy / dx
    np.fill_diagonal(slopes, np.nan)
    slope_i = np.nanmedian(slopes, axis=1)
    slope = float(np.median(slope_i))
    intercept = float(np.median(y - slope * x))
    return slope, intercept


def robust_poly_fit(x: np.ndarray, y: np.ndarray, degree: int = 1,
                    sigma: float = 3.0, iters: int = 3) -> np.ndarray:
    """Sigma-clipped iterative LSQ polynomial (GSL robust fit analog)."""
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    keep = np.ones(x.size, bool)
    if degree == 1:
        # seed with the 50%-breakdown Siegel line so a heavy outlier
        # fraction can't skew the initial residuals (fitting.c couples
        # the two the same way)
        s0, i0 = siegel_fit(x, y)
        coef = np.array([i0, s0])
    else:
        coef = poly_fit(x, y, degree)
    for _ in range(iters):
        pred = np.polynomial.polynomial.polyval(x, coef)
        r = y - pred
        # robust scale (MAD) so gross outliers can't inflate the cut
        rk = r[keep]
        s = 1.4826 * np.median(np.abs(rk - np.median(rk)))
        if s == 0:
            break
        new = np.abs(r) <= sigma * s
        if new.sum() < degree + 1 or np.array_equal(new, keep):
            break
        keep = new
        coef = poly_fit(x[keep], y[keep], degree)
    return coef


def find_linear_coeff(img: np.ndarray, ref: np.ndarray,
                      low: float = 1e-7, high: float = 0.92
                      ) -> Tuple[float, float]:
    """Per-channel linear fit of image to reference within [low, high]
    (find_linear_coeff, fitting.c:325) → (a, b) with ref ≈ a·img + b."""
    m = (img > low) & (img < high) & (ref > low) & (ref < high)
    xi = img[m].astype(np.float64)
    yi = ref[m].astype(np.float64)
    if xi.size < 16:
        return 1.0, 0.0
    a, b = np.polyfit(xi, yi, 1)
    return float(a), float(b)
