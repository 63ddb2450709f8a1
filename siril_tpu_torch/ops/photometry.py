"""Aperture photometry — counterpart of ``siril_tpu/ops/photometry.py``
(src/algos/photometry.c getPhotometryData:86-226): ``PhotConfig`` (:33),
``PhotResult`` (:47), ``robust_mean`` (:58) and ``measure_star`` (:75),
host numpy as in the JAX package.

- aperture radius = 0.5·fwhmx·auto_aperture_factor unless forced
- fractional pixel coverage f = 1 inside (r < (R−0.5)²) else
  clamp(R − √r + 0.5, 0, 1)
- sky = robust (sigma-clipped) mean of annulus [inner, outer] pixels
  within [minval, maxval]
- intensity = Σ f·pixel − area·sky_mean
- mag = −2.5·log₁₀(I);  σ_mag = 1.0857·noise/I with
  noise² = area·σ_sky² + I/gain + (σ_sky²/n_sky)·area²
- SNR = 10·log₁₀(I / noise)

The sequence photometry (``seq_photometry``, ``light_curve``,
``save_aavso_extended``: seqpsf and the light curves) is not ported yet
(ROADMAP §1.5).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import numpy as np

MIN_SKY = 5


@dataclass
class PhotConfig:
    """phot_config (settings.h phot_set) defaults."""

    gain: float = 2.3             # e-/ADU (cvf)
    inner: float = 20.0
    outer: float = 30.0
    aperture: float = 10.0
    force_radius: bool = False
    auto_aperture_factor: float = 2.0
    minval: float = -1500.0 / 65535.0
    maxval: float = 60000.0 / 65535.0


@dataclass
class PhotResult:
    mag: float = 0.0
    s_mag: float = 9.999
    snr: float = 0.0
    intensity: float = 0.0
    sky: float = 0.0
    valid: bool = False
    error: str = ""


def robust_mean(data: np.ndarray, k: float = 3.0, iters: int = 5):
    """Sigma-clipped mean (algos robustmean equivalent)."""
    d = np.asarray(data, np.float64)
    for _ in range(iters):
        if d.size < 2:
            break
        m = d.mean()
        s = d.std(ddof=1)
        keep = np.abs(d - m) <= k * s
        if keep.all():
            break
        d = d[keep]
    if d.size == 0:
        return 0.0, 0.0
    return float(d.mean()), float(d.std(ddof=1) if d.size > 1 else 0.0)


def measure_star(layer: np.ndarray, x0: float, y0: float, fwhm: float,
                 cfg: Optional[PhotConfig] = None,
                 gain_from_image: Optional[float] = None) -> PhotResult:
    """Photometry of one star on one (H,W) layer (float [0,1] data —
    gain is scaled by 65535 like the reference's DATA_FLOAT path)."""
    cfg = cfg or PhotConfig()
    H, W = layer.shape
    res = PhotResult()
    if not (0 < x0 < W and 0 < y0 < H):
        res.error = "out_of_window"
        return res
    r1 = cfg.inner
    r2 = cfg.outer
    appR = cfg.aperture if cfg.force_radius else \
        0.5 * fwhm * cfg.auto_aperture_factor
    if appR >= r1 and not cfg.force_radius:
        res.error = "inner_too_small"
        return res
    gain = (gain_from_image or cfg.gain) * 65535.0

    x1 = max(int(x0 - r2), 1)
    x2 = min(int(x0 + r2), W - 1)
    y1 = max(int(y0 - r2), 1)
    y2 = min(int(y0 + r2), H - 1)
    if x2 <= x1 or y2 <= y1:
        res.error = "out_of_window"
        return res
    yy, xx = np.mgrid[y1:y2 + 1, x1:x2 + 1]
    r_sq = (yy - y0) ** 2 + (xx - x0) ** 2
    sub = layer[y1:y2 + 1, x1:x2 + 1].astype(np.float64)
    in_range = (sub > cfg.minval) & (sub < cfg.maxval)
    rmin_sq = (appR - 0.5) ** 2
    f = np.where(r_sq < rmin_sq, 1.0, appR - np.sqrt(r_sq) + 0.5)
    f = np.clip(f, 0.0, 1.0) * in_range
    area = f.sum()
    apmag = (sub * f).sum()
    sky_mask = (r_sq > r1 * r1) & (r_sq < r2 * r2) & in_range
    skypix = sub[sky_mask]
    if area < 1.0:
        res.error = "aperture_too_small"
        return res
    if skypix.size < MIN_SKY:
        res.error = "too_few_bg_pixels"
        return res
    mean, stdev = robust_mean(skypix)
    intensity = apmag - area * mean
    res.sky = mean
    res.intensity = intensity
    if intensity <= 0:
        res.error = "negative_intensity"
        return res
    res.mag = -2.5 * math.log10(intensity)
    skyvar = stdev * stdev
    noise = math.sqrt(area * skyvar + intensity / gain
                      + (skyvar / skypix.size) * area * area)
    res.snr = 10.0 * math.log10(intensity / noise) if noise > 0 else 0.0
    res.s_mag = min(9.999, 1.0857 * noise / intensity)
    res.valid = res.s_mag < 9.999
    return res
