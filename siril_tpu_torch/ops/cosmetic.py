"""Cosmetic correction from a master dark — counterpart of
``siril_tpu/ops/cosmetic.py`` (``detect_deviant_from_dark``:27,
``_neighbor_stack``:50, ``_offsets``:65, ``correct_deviant``:74;
reference ``src/filters/cosmetic_correction.c``: find_deviant_pixels:203,
cosmeticCorrOnePoint:285).

The deviant map comes from the master dark's median ± k·σ (the JAX
package's numpy statistics, copied here so that the masks are equal).
A cold pixel takes the median of its 5×5 neighbourhood without itself
(24 values: the mean of the two middle ones, as ``jnp.median``), a hot
pixel the mean of its 3×3 neighbourhood without itself; a CFA frame
samples the same colour at stride 2; the frame's edge is replicated.
The JAX package evaluates both replacements at every pixel; here they are
gathered at the deviant pixels only, which gives the same values.

``auto_detect_and_correct`` and ``apply_cosme_file`` (the ``find_hot`` /
``cosme`` commands) are not ported yet (ROADMAP §1.5, the image ops).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch


def _median_sigma_np(x: np.ndarray) -> Tuple[float, float]:
    """STATS_BASIC median and σ of a layer's non-zero, non-NaN pixels
    (``siril_tpu/ops/statistics.py`` compute_stats_np, median_np, sd_np)."""
    flat = x.ravel()
    good = flat[(flat != 0.0) & ~np.isnan(flat)]
    if good.size == 0:
        return 0.0, 0.0
    med = float(np.median(good))
    n = good.size
    if n < 2:
        return med, 0.0
    mean = np.float32(good.sum(dtype=np.float64) / n)
    d = good - mean
    vsum = np.einsum("i,i->", d, d, dtype=np.float64)
    return med, float(np.sqrt(np.float32(vsum / (n - 1))))


def detect_deviant_from_dark(dark_layer: np.ndarray, sig_cold: float,
                             sig_hot: float
                             ) -> Tuple[np.ndarray, np.ndarray]:
    """(cold_mask, hot_mask) from master-dark statistics; σ < 0 disables."""
    median, sigma = _median_sigma_np(dark_layer)
    z = np.zeros_like(dark_layer, bool)
    if sigma <= 0.0:
        return z, z              # a constant master dark: nothing deviates
    cold, hot = z, z
    if sig_cold >= 0:
        cold = dark_layer <= max(median - sig_cold * sigma, 0.0)
    if sig_hot >= 0:
        hot = dark_layer >= min(median + sig_hot * sigma, 1.0)
    return cold, hot


def _offsets(radius: int, cfa: bool,
             include_center: bool = False) -> List[Tuple[int, int]]:
    step = 2 if cfa else 1
    r = radius * step
    return [(dy, dx) for dy in range(-r, r + 1, step)
            for dx in range(-r, r + 1, step)
            if include_center or (dy, dx) != (0, 0)]


def _neighbor_stack(ys: np.ndarray, xs: np.ndarray, offsets, H: int,
                    W: int) -> np.ndarray:
    """Flat indices (len(offsets), n) of the neighbours of the pixels
    (ys, xs) at ``offsets``, edge replicated: the JAX package's stack of
    edge-padded shifted copies, taken at those pixels only."""
    offs = np.array(offsets, np.int64).reshape(-1, 2)
    yy = np.clip(ys[None] - offs[:, :1], 0, H - 1)
    xx = np.clip(xs[None] - offs[:, 1:], 0, W - 1)
    return yy * W + xx


def _median_even(v: torch.Tensor) -> torch.Tensor:
    """``jnp.median`` over axis 0: the mean of the two middle values of an
    even count, NaN where any value is NaN."""
    s = torch.sort(v, dim=0).values
    m = v.shape[0]
    med = (s[(m - 1) // 2] + s[m // 2]) * 0.5
    return torch.where(torch.isnan(v).any(0), torch.nan, med)


def deviant_plan(cold: np.ndarray, hot: np.ndarray, is_cfa: bool,
                 device: torch.device):
    """Gather plan of the replacements: (pixels, their 24 neighbours of
    5×5) for the cold map, (pixels, their 8 neighbours of 3×3) for the
    hot map, as flat indices on ``device``."""
    H, W = cold.shape
    plan = []
    for mask, radius in ((cold, 2), (hot, 1)):
        ys, xs = np.nonzero(mask)
        nb = _neighbor_stack(ys, xs, _offsets(radius, is_cfa), H, W)
        plan.append((torch.as_tensor(ys * W + xs, device=device),
                     torch.as_tensor(nb, device=device)))
    return plan


def apply_cosmetic(x: torch.Tensor, plan) -> torch.Tensor:
    """Cold → median of the 5×5 neighbours, hot → mean of the 3×3 ones,
    both read from ``x`` (..., H, W) before any replacement; hot wins
    where a pixel is both."""
    flat = x.reshape(*x.shape[:-2], -1)
    out = flat.clone()
    (cpix, cnb), (hpix, hnb) = plan
    if cpix.numel():
        out[..., cpix] = _median_even(flat[..., cnb].movedim(-2, 0))
    if hpix.numel():
        nb = flat[..., hnb]
        acc = nb[..., 0, :]
        for i in range(1, nb.shape[-2]):      # in offset order, as XLA sums
            acc = acc + nb[..., i, :]
        out[..., hpix] = acc / nb.shape[-2]
    return out.reshape(x.shape)


def correct_deviant(layer: torch.Tensor, cold_mask: np.ndarray,
                    hot_mask: np.ndarray,
                    is_cfa: bool = False) -> torch.Tensor:
    """Apply the replacement rules to one (H, W) float32 layer."""
    return apply_cosmetic(layer, deviant_plan(
        np.asarray(cold_mask, bool), np.asarray(hot_mask, bool), is_cfa,
        layer.device))
