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

``auto_detect_and_correct`` (:93, ``find_cosme`` / ``seqfind_cosme``)
flags a pixel whose deviation from the median of its 24 neighbours passes
k·avgDev of the layer; that median runs at every pixel, on the device, in
row blocks of shifted copies (24 copies of a 4096² layer take 1.6 GB).
``apply_cosme_file`` (:115, ``cosme``) corrects the points, lines and
columns of a list file.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from siril_tpu_torch.device import DeviceLike, resolve_device


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


def _neighbor_stack(ys: torch.Tensor, xs: torch.Tensor, offsets, H: int,
                    W: int) -> torch.Tensor:
    """Flat indices (len(offsets), n) of the neighbours of the pixels
    (ys, xs) at ``offsets``, edge replicated: the JAX package's stack of
    edge-padded shifted copies, taken at those pixels only."""
    offs = torch.tensor(offsets, dtype=torch.int64,
                        device=ys.device).reshape(-1, 2)
    yy = torch.clamp(ys[None] - offs[:, :1], 0, H - 1)
    xx = torch.clamp(xs[None] - offs[:, 1:], 0, W - 1)
    return yy * W + xx


def _median_even(v: torch.Tensor) -> torch.Tensor:
    """``jnp.median`` over axis 0: the mean of the two middle values of an
    even count, NaN where any value is NaN."""
    s = torch.sort(v, dim=0).values
    m = v.shape[0]
    med = (s[(m - 1) // 2] + s[m // 2]) * 0.5
    return torch.where(torch.isnan(v).any(0), torch.nan, med)


def deviant_plan(cold, hot, is_cfa: bool, device: torch.device):
    """Gather plan of the replacements: (pixels, their 24 neighbours of
    5×5) for the cold map, (pixels, their 8 neighbours of 3×3) for the
    hot map, as flat indices on ``device``; the maps are numpy arrays or
    tensors, their pixels taken in row order on the device."""
    plan = []
    for mask, radius in ((cold, 2), (hot, 1)):
        m = torch.as_tensor(mask, dtype=torch.bool, device=device)
        H, W = m.shape
        ys, xs = torch.nonzero(m, as_tuple=True)
        plan.append((ys * W + xs, _neighbor_stack(
            ys, xs, _offsets(radius, is_cfa), H, W)))
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


def correct_deviant(layer: torch.Tensor, cold_mask, hot_mask,
                    is_cfa: bool = False) -> torch.Tensor:
    """Apply the replacement rules to one (H, W) float32 layer (the masks:
    numpy arrays or tensors)."""
    return apply_cosmetic(layer, deviant_plan(cold_mask, hot_mask, is_cfa,
                                              layer.device))


# ---------------------------------------------------------------------------
# auto detection (find_cosme) and list files (cosme)
# ---------------------------------------------------------------------------

#: bytes of shifted copies (and their sort) a row block of the 24-neighbour
#: median may hold
_MEDIAN_BLOCK_BYTES = 1 << 29


def neighbour_median(x: torch.Tensor, is_cfa: bool = False) -> torch.Tensor:
    """``jnp.median`` of the 24 neighbours of 5×5 (stride 2 for a CFA) at
    every pixel of an (H, W) layer, the edge replicated: the mean of the
    two middle values, NaN where a neighbour is NaN.  Row blocks bound the
    copies."""
    H, W = x.shape
    offs = _offsets(2, is_cfa)
    R = max(abs(dy) for dy, _ in offs)
    pad = torch.nn.functional.pad(x[None, None], (R, R, R, R),
                                  mode="replicate")[0, 0]
    rows = max(1, min(H, _MEDIAN_BLOCK_BYTES // (W * len(offs) * 16)))
    out = torch.empty_like(x)
    m = len(offs)
    for r0 in range(0, H, rows):
        r1 = min(H, r0 + rows)
        nb = torch.stack([pad[R - dy + r0:R - dy + r1, R - dx:R - dx + W]
                          for dy, dx in offs], dim=-1)
        s = torch.sort(nb, dim=-1).values
        med = (s[..., (m - 1) // 2] + s[..., m // 2]) * 0.5
        out[r0:r1] = torch.where(torch.isnan(nb).any(-1), torch.nan, med)
        del nb, s
    return out


def auto_detect_tensor(x: torch.Tensor, sig_hot: Optional[float] = 3.0,
                       sig_cold: Optional[float] = None,
                       is_cfa: bool = False):
    """(corrected, cold, hot) of one float32 (H, W) layer where it lies:
    hot where x − median24 > sig_hot·max(avgDev, 1e-7), cold where
    median24 − x > sig_cold·…; then ``correct_deviant``: cold pixels
    take median24, hot ones the mean of their 3×3 neighbours (hot
    wins).  The thresholds are Python
    floats that JAX's weak typing rounds to float32 before comparing:
    they are rounded here the same way."""
    from siril_tpu_torch.ops.statistics import (
        STATS_AVGDEV,
        compute_stats_tensor,
    )

    avgdev = compute_stats_tensor(x, STATS_AVGDEV).avgdev
    med5 = neighbour_median(x, is_cfa)
    dev = x - med5
    z = torch.zeros_like(x, dtype=torch.bool)

    def thr(sig):
        return torch.tensor(np.float32(sig * max(avgdev, 1e-7)),
                            device=x.device)

    hot = dev > thr(sig_hot) if sig_hot is not None else z
    cold = -dev > thr(sig_cold) if sig_cold is not None else z
    return correct_deviant(x, cold, hot, is_cfa), cold, hot


def auto_detect_and_correct(layer, sig_hot: Optional[float] = 3.0,
                            sig_cold: Optional[float] = None,
                            is_cfa: bool = False,
                            device: DeviceLike = None):
    """find_hot / auto mode (``auto_detect_and_correct``:93) of one host
    layer on ``device`` → (corrected float32 array, cold mask, hot
    mask)."""
    x = torch.from_numpy(np.ascontiguousarray(layer, np.float32)).to(
        resolve_device(device))
    out, cold, hot = auto_detect_tensor(x, sig_hot, sig_cold, is_cfa)
    return out.cpu().numpy(), cold.cpu().numpy(), hot.cpu().numpy()


def apply_cosme_file(img, entries, is_cfa: bool = False,
                     device: DeviceLike = None) -> np.ndarray:
    """``cosme``: the entries ('P', x, y) → the mean of the pixel's 3×3
    neighbours (every point is taken as hot, whatever its type letter,
    as the JAX package does), then ('L', y) rows and ('C', x) columns →
    the mean of their two neighbours, one after another in file order;
    y is top-down here."""
    dev = resolve_device(device)
    data = torch.from_numpy(np.ascontiguousarray(img.host())).to(dev)
    C, H, W = data.shape
    hot = np.zeros((H, W), bool)
    lines, cols = [], []
    for e in entries:
        kind = e[0].upper()
        if kind == "P":
            x, y = int(e[1]), int(e[2])
            if 0 <= x < W and 0 <= y < H:
                hot[y, x] = True
        elif kind == "L":
            lines.append(int(e[1]))
        elif kind == "C":
            cols.append(int(e[1]))
    cold = np.zeros_like(hot)
    out = []
    for c in range(C):
        lay = correct_deviant(data[c], cold, hot, is_cfa)
        for y in lines:
            if 0 <= y < H:
                lay[y] = 0.5 * (lay[max(y - 1, 0)] + lay[min(y + 1, H - 1)])
        for x in cols:
            if 0 <= x < W:
                lay[:, x] = 0.5 * (lay[:, max(x - 1, 0)]
                                   + lay[:, min(x + 1, W - 1)])
        out.append(lay)
    return torch.stack(out).cpu().numpy()
