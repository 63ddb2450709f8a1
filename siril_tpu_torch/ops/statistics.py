"""Image statistics and robust per-frame estimators — counterpart of
``siril_tpu/ops/statistics.py``: ``ImStats`` (:52), the basic statistics
of ``compute_stats_np(…, STATS_BASIC)`` (:223) with the background noise
``bgnoise_np`` (:177) / ``_bgnoise_dense`` (:132), ``hist_median_jax``
(:344) and ``norm_estimators_hist_jax`` (:413); and the host numpy
IKSSlite of the overlap normalization (``median_np``:89, ``mad_np``:93,
``bwmv_np``:101, ``ikss_lite_np``:114).  The image ops read the host
``compute_stats_np`` (:223, every option, with ``sd_np``:73,
``bgnoise_np``:177 and ``_diff_sigma``:215) as the JAX package does.
The analysis commands (``stat``, ``bg``, ``bgnoise``, ``seqstat``,
``entropy``, ``histo``) read ``compute_stats_image`` (:254) and
``histogram256`` on the session's device: exact medians by a sort,
float64 sums, and numpy's histogram bins.

The reference's median is the lower-median sample for odd counts and the
mean of the middle pair for even counts, 0 for an empty row.  The TPU
version reaches that order statistic by an 8-way value bisection because
scatter-add ran serially there (statistics.py:350-359); on the GPU a sort
gives the same order statistic directly.

The JAX package computes the basic statistics on the host in numpy; here
they are torch code that runs where the frame lies (on the card, the
frame of the resident stack), keeping the reference's float64
accumulations.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from siril_tpu_torch.ops.rejection import fma


def median_rows(x: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Median over the last axis of the entries where ``valid``; (R, P) →
    (R,).  Rows with no valid entry give 0."""
    xs = torch.sort(torch.where(valid, x, float("inf")), dim=-1).values
    n = valid.sum(-1)
    last = x.shape[-1] - 1
    i_lo = torch.clamp((n + 1) // 2 - 1, 0, last)
    i_hi = torch.clamp(n // 2, 0, last)
    v_lo = xs.gather(-1, i_lo[:, None])[:, 0]
    v_hi = xs.gather(-1, i_hi[:, None])[:, 0]
    med = torch.where(n % 2 == 0, 0.5 * (v_lo + v_hi), v_lo)
    return torch.where(n > 0, med, 0.0)


def norm_estimators(frames: torch.Tensor, lite: bool = False) -> dict:
    """Per-frame (median, mad, location, scale) over the non-zero finite
    pixels of ``frames`` (N, P): IKSSlite location and biweight-midvariance
    scale, or median and 1.5·MAD with ``lite`` (normalization.c:98-142)."""
    valid = (frames != 0.0) & torch.isfinite(frames)
    med = median_rows(frames, valid)
    mad = median_rows(torch.abs(frames - med[:, None]), valid)
    if lite:
        return {"median": med, "mad": mad, "location": med,
                "scale": 1.5 * mad}
    lo = fma(-6.0, mad, med)
    hi = fma(6.0, mad, med)
    valid2 = valid & (frames >= lo[:, None]) & (frames <= hi[:, None])
    loc = median_rows(frames, valid2)
    mad2 = median_rows(torch.abs(frames - loc[:, None]), valid2)
    factor = 1.0 / (9.0 * torch.clamp_min(mad2, 1e-30))
    i_med = torch.where(valid2, frames - loc[:, None], 0.0)
    yi = i_med * factor[:, None]
    yi2 = torch.where(torch.abs(yi) < 1.0, yi * yi, 1.0)
    one_m = 1.0 - yi2
    up_t = torch.where(valid2, (i_med * (one_m * one_m)) ** 2, 0.0)
    dn_t = torch.where(valid2, one_m * fma(-5.0, yi2, 1.0), 0.0)
    up = up_t.sum(-1)
    dn = dn_t.sum(-1)
    nvalid = valid2.sum(-1)
    bwmv = torch.where(dn != 0, nvalid * (up / torch.where(
        dn == 0, 1.0, dn) ** 2), 0.0)
    scale = torch.sqrt(bwmv) * 0.991
    return {"median": med, "mad": mad, "location": loc,
            "scale": torch.where(scale > 0, scale, 1.5 * mad)}


@dataclass
class ImStats:
    """Per-layer image statistics (imstats, siril.h:407-413)."""

    total: float = 0
    ngoodpix: float = 0
    mean: float = 0.0
    median: float = 0.0
    sigma: float = 0.0
    avgdev: float = 0.0
    mad: float = 0.0
    sqrtbwmv: float = 0.0
    location: float = 0.0
    scale: float = 0.0
    min: float = 0.0
    max: float = 0.0
    normvalue: float = 1.0
    bgnoise: float = 0.0


def _median_f64(v: torch.Tensor) -> float:
    """np.median of a 1-D float64 tensor (mean of the middle pair)."""
    s = torch.sort(v).values
    n = s.numel()
    return float(0.5 * (s[(n - 1) // 2] + s[n // 2]))


def bgnoise(layer2d: torch.Tensor) -> float:
    """FnNoise1 (quantize.c): per row, the 5σ-clipped (3 passes) standard
    deviation of the first differences between consecutive valid
    (non-zero, non-NaN) pixels, over √2; the median over rows.

    All rows at once, as ``_bgnoise_dense`` does for a layer with no
    invalid pixel; a layer with invalid pixels follows the per-row loop
    of ``bgnoise_np``: rows with fewer than 3 valid pixels are skipped,
    and deviations are taken in float64 where the dense path takes them
    in float32.  Sums are float64 as in the reference."""
    SIGMA_CLIP, NITER = 5.0, 3
    ny, nx = layer2d.shape
    if nx < 3:
        return 0.0
    x = layer2d.float()
    good = (x != 0.0) & ~torch.isnan(x)
    dense = bool(good.all())
    if dense:
        d = x[:, :-1] - x[:, 1:]
        keep = torch.ones_like(d, dtype=torch.bool)
    else:
        # valid pixels of each row first, in their order
        order = torch.argsort((~good).to(torch.uint8), dim=1, stable=True)
        vals = x.gather(1, order)
        ngood = good.sum(1)
        d = vals[:, :-1] - vals[:, 1:]
        col = torch.arange(nx - 1, device=x.device)
        keep = col[None, :] < (ngood - 1)[:, None]
        rows = ngood >= 3
        d, keep = d[rows], keep[rows]
        if d.shape[0] == 0:
            return 0.0

    def moments(keep):
        cnt = keep.sum(1)
        mean = torch.where(keep, d, 0.0).double().sum(1) / \
            torch.clamp_min(cnt, 1)
        if dense:
            dev = torch.where(keep, d - mean.float()[:, None], 0.0)
            vsum = (dev * dev).double().sum(1)
        else:
            dev = torch.where(keep, d.double() - mean[:, None], 0.0)
            vsum = (dev * dev).sum(1)
        return cnt, mean, torch.sqrt(vsum / torch.clamp_min(cnt - 1, 1))

    cnt, mean, stdev = moments(keep)
    frozen = stdev <= 0.0
    for _ in range(NITER):
        if bool(frozen.all()):
            break
        thr = (SIGMA_CLIP * stdev).float()
        nkeep = keep & (torch.abs(d - mean.float()[:, None]) < thr[:, None])
        changed = ~frozen & (nkeep != keep).any(1)
        frozen = frozen | ~changed
        keep = torch.where(changed[:, None], nkeep, keep)
        ncnt, nmean, nstd = moments(keep)
        small = changed & (ncnt < 2)     # < 2 survivors: keep last stdev
        frozen = frozen | small
        upd = changed & ~small
        mean = torch.where(upd, nmean, mean)
        stdev = torch.where(upd, nstd, stdev)
    return _median_f64(stdev / math.sqrt(2.0))


def sd_f64(good: torch.Tensor) -> float:
    """Sample sd (N−1) with float64 sums over float32 deviations from a
    float32 mean (statistics.h:82-106, ``sd_np``)."""
    n = good.numel()
    if n < 2:
        return 0.0
    mean = (good.double().sum() / n).float()
    d = (good - mean).double()
    return float(torch.sqrt((d * d).sum() / (n - 1)).float())


def compute_stats_basic(layer2d: torch.Tensor) -> ImStats:
    """imstats of one layer with STATS_BASIC (``compute_stats_np``:223):
    mean, sigma, min, max, background noise and median of the non-zero,
    non-NaN pixels."""
    st = ImStats()
    flat = layer2d.reshape(-1).float()
    st.total = flat.numel()
    good = flat[(flat != 0.0) & ~torch.isnan(flat)]
    st.ngoodpix = good.numel()
    if good.numel() == 0:
        return st
    st.mean = float(good.double().sum() / good.numel())
    st.sigma = sd_f64(good)
    st.min = float(good.min())
    st.max = float(good.max())
    st.bgnoise = bgnoise(layer2d)
    s = torch.sort(good).values
    n = s.numel()
    st.median = float(0.5 * (s[(n - 1) // 2] + s[n // 2]))
    return st


# ---------------------------------------------------------------------------
# host numpy estimators (the overlap normalization's, on one overlap)
# ---------------------------------------------------------------------------


def median_np(x: np.ndarray) -> float:
    return float(np.median(x)) if x.size else 0.0


def mad_np(x: np.ndarray, med: float) -> float:
    """median(|x − med|) (statistics_float.c:80)."""
    if x.size == 0:
        return 0.0
    return float(np.median(np.abs(x - np.float32(med))))


def bwmv_np(x: np.ndarray, mad: float, med: float) -> float:
    """Biweight midvariance (statistics_float.c:103-127)."""
    if mad <= 0.0 or x.size == 0:
        return 0.0
    factor = np.float32(1.0 / (9.0 * mad))
    i_med = x - np.float32(med)
    yi = i_med * factor
    yi2 = np.where(np.abs(yi) < 1.0, yi * yi, np.float32(1.0))
    up = ((i_med * (1.0 - yi2) ** 2) ** 2).sum(dtype=np.float64)
    down = ((1.0 - yi2) * (1.0 - 5.0 * yi2)).sum(dtype=np.float64)
    return float(x.size * (up / (down * down))) if down else 0.0


def ikss_lite_np(x: np.ndarray, med: float, mad: float):
    """IKSSlite (location, scale) of ``x`` (statistics_float.c:199-230),
    or None if degenerate."""
    kept = x[(x >= med - 6.0 * mad) & (x <= med + 6.0 * mad)]
    if kept.size == 0:
        return None
    loc = median_np(kept)
    m2 = mad_np(kept, loc)
    if m2 == 0.0:
        return None
    return loc, float(np.sqrt(bwmv_np(kept, m2, loc)) * 0.991)


# ---------------------------------------------------------------------------
# host numpy statistics of one layer (``compute_stats_np``: the autostretch
# finders, pcc, spcc, bgneutralize and satu read them on the host, as the
# JAX package does)
# ---------------------------------------------------------------------------

#: stats option bitmask (statistics.h:25-37)
STATS_SIGMEAN = 1 << 1
STATS_BASIC = 1 << 2
STATS_MAD = 1 << 3
STATS_AVGDEV = 1 << 4
STATS_BWMV = 1 << 5
STATS_IKSS = 1 << 6
STATS_MAIN = STATS_BASIC | STATS_AVGDEV | STATS_MAD | STATS_BWMV
STATS_EXTRA = STATS_MAIN | STATS_IKSS


def sd_np(x: np.ndarray) -> float:
    """Sample sd (N−1) with float64 sums over float32 deviations from a
    float32 mean (statistics.h:82-106)."""
    n = x.size
    if n < 2:
        return 0.0
    mean = np.float32(x.sum(dtype=np.float64) / n)
    d = x - mean
    vsum = np.einsum("i,i->", d, d, dtype=np.float64)
    return float(np.sqrt(np.float32(vsum / (n - 1))))


def _diff_sigma(d: np.ndarray, mean: float) -> float:
    n = d.size
    if n < 2:
        return 0.0
    v = ((d.astype(np.float64) - mean) ** 2).sum() / (n - 1)
    return float(np.sqrt(v))


def _bgnoise_dense_np(layer2d: np.ndarray, sigma_clip: float,
                      niter: int) -> float:
    """FnNoise1 of a layer with no invalid pixel: every row at once."""
    d = (layer2d[:, :-1] - layer2d[:, 1:]).astype(np.float32)
    ny, m = d.shape
    keep = np.ones_like(d, bool)
    cnt = np.full(ny, m, np.int64)
    mean = d.sum(axis=1, dtype=np.float64) / m
    dev = d - mean[:, None].astype(np.float32)
    vsum = (dev * dev).sum(axis=1, dtype=np.float64)
    stdev = np.sqrt(vsum / np.maximum(cnt - 1, 1))
    frozen = np.zeros(ny, bool)
    for _ in range(niter):
        active = ~frozen & (stdev > 0.0)
        if not active.any():
            break
        thr = (sigma_clip * stdev).astype(np.float32)
        nkeep = keep & (np.abs(d - mean[:, None].astype(np.float32))
                        < thr[:, None])
        changed = active & ((nkeep != keep).any(axis=1))
        frozen |= ~changed
        if not changed.any():
            break
        keep = np.where(changed[:, None], nkeep, keep)
        cnt = keep.sum(axis=1)
        small = changed & (cnt < 2)      # < 2 survivors: keep last stdev
        frozen |= small
        upd = changed & ~small
        if upd.any():
            dk = np.where(keep, d, np.float32(0.0))
            nm = dk.sum(axis=1, dtype=np.float64) / np.maximum(cnt, 1)
            devk = np.where(keep, d - nm[:, None].astype(np.float32),
                            np.float32(0.0))
            nv = (devk * devk).sum(axis=1, dtype=np.float64)
            ns = np.sqrt(nv / np.maximum(cnt - 1, 1))
            mean = np.where(upd, nm, mean)
            stdev = np.where(upd, ns, stdev)
    return float(np.median(stdev / np.sqrt(2.0)))


def bgnoise_np(layer2d: np.ndarray) -> float:
    """FnNoise1 (quantize.c) on the host: the median over rows of the
    5σ-clipped (3 passes) sd of the first differences between valid
    pixels, over √2."""
    sigma_clip, niter = 5.0, 3
    ny, nx = layer2d.shape
    if nx < 3:
        return 0.0
    if not ((layer2d == 0.0) | np.isnan(layer2d)).any():
        return _bgnoise_dense_np(layer2d, sigma_clip, niter)
    out = []
    for j in range(ny):
        row = layer2d[j]
        good = row[(row != 0.0) & ~np.isnan(row)]
        if good.size < 3:
            continue
        d = (good[:-1] - good[1:]).astype(np.float32)
        mean = float(d.astype(np.float64).mean())
        stdev = _diff_sigma(d, mean)
        if stdev > 0.0:
            for _ in range(niter):
                keep = np.abs(d - np.float32(mean)) < sigma_clip * stdev
                if keep.all():
                    break
                d = d[keep]
                if d.size < 2:
                    break
                mean = float(d.astype(np.float64).mean())
                stdev = _diff_sigma(d, mean)
        out.append(stdev / np.sqrt(2.0))
    return float(np.median(out)) if out else 0.0


def per_layer(fn, layers) -> list:
    """[fn(layer) for layer in layers], the layers on host threads at once
    (numpy's medians and sums release the GIL; each result is the one a
    loop gives)."""
    import concurrent.futures as cf

    layers = list(layers)
    if len(layers) < 2:
        return [fn(x) for x in layers]
    with cf.ThreadPoolExecutor(max_workers=len(layers)) as pool:
        return list(pool.map(fn, layers))


def compute_stats_np(layer2d: np.ndarray,
                     options: int = STATS_BASIC) -> ImStats:
    """imstats of one host layer (``compute_stats_np``:223) over the
    non-zero, non-NaN pixels, for every option.  The default stays
    STATS_BASIC (the image ops' callers); the JAX package's is
    STATS_MAIN."""
    st = ImStats()
    flat = layer2d.ravel()
    st.total = flat.size
    good = flat[(flat != 0.0) & ~np.isnan(flat)]
    st.ngoodpix = good.size
    if good.size == 0:
        return st
    if options & (STATS_BASIC | STATS_SIGMEAN):
        st.mean = float(good.sum(dtype=np.float64) / good.size)
        st.sigma = sd_np(good)
        st.min = float(good.min())
        st.max = float(good.max())
        st.bgnoise = bgnoise_np(layer2d)
    if options & (STATS_BASIC | STATS_MAD | STATS_AVGDEV | STATS_BWMV
                  | STATS_IKSS):
        st.median = median_np(good)
    if options & (STATS_MAD | STATS_BWMV | STATS_IKSS):
        st.mad = mad_np(good, st.median)
    if options & STATS_AVGDEV:
        st.avgdev = float(np.abs(good - np.float32(st.median)).sum(
            dtype=np.float64) / good.size)
    if options & (STATS_BWMV | STATS_IKSS):
        st.sqrtbwmv = float(np.sqrt(bwmv_np(good, st.mad, st.median)))
    if options & STATS_IKSS:
        r = ikss_lite_np(good, st.median, st.mad)
        if r is not None:
            st.location, st.scale = r
    return st


# ---------------------------------------------------------------------------
# the same statistics on the device (the analysis commands)
# ---------------------------------------------------------------------------


def median_t(v: torch.Tensor, presorted: bool = False) -> torch.Tensor:
    """np.median of a float32 tensor (every element), as a 0-d tensor
    where it lies: the middle value, or the float32 mean of the middle
    pair."""
    s = v.reshape(-1) if presorted else torch.sort(v.reshape(-1)).values
    n = s.numel()
    return (s[(n - 1) // 2] + s[n // 2]) * 0.5


def _median_sorted(s: torch.Tensor) -> float:
    return float(median_t(s, presorted=True))


def _sd_t(good: torch.Tensor) -> float:
    """``sd_np``: float64 sums over float32 deviations from a float32
    mean; the variance rounded to float32 and its root rounded to float32
    (taken in float64: torch's float32 sqrt on the CPU is not correctly
    rounded, and numpy's is)."""
    n = good.numel()
    if n < 2:
        return 0.0
    mean = (good.double().sum() / n).float()
    d = (good - mean).double()
    var = ((d * d).sum() / (n - 1)).float()
    return float(torch.sqrt(var.double()).float())


def _bwmv_t(x: torch.Tensor, mad: float, med: float) -> float:
    """``bwmv_np``: float32 terms, float64 sums."""
    if mad <= 0.0 or x.numel() == 0:
        return 0.0
    factor = torch.tensor(np.float32(1.0 / (9.0 * mad)), device=x.device)
    i_med = x - torch.tensor(np.float32(med), device=x.device)
    yi = i_med * factor
    yi2 = torch.where(torch.abs(yi) < 1.0, yi * yi, 1.0)
    one_m = 1.0 - yi2
    up = ((i_med * (one_m * one_m)) ** 2).double().sum()
    down = (one_m * (1.0 - 5.0 * yi2)).double().sum()
    up, down = float(up), float(down)
    return float(x.numel() * (up / (down * down))) if down else 0.0


def _mad_t(x: torch.Tensor, med: float) -> float:
    """median(|x − float32(med)|)."""
    return _median_sorted(torch.sort(torch.abs(
        x - torch.tensor(np.float32(med), device=x.device))).values)


def compute_stats_tensor(layer2d: torch.Tensor,
                         options: int = STATS_MAIN) -> ImStats:
    """``compute_stats_np`` of one layer where the tensor lies: the same
    numbers, from exact sorted medians and float64 sums (the sums in
    another order: the means agree to ~1e-15)."""
    st = ImStats()
    flat = layer2d.reshape(-1).float()
    st.total = flat.numel()
    good = flat[(flat != 0.0) & ~torch.isnan(flat)]
    n = good.numel()
    st.ngoodpix = n
    if n == 0:
        return st
    if options & (STATS_BASIC | STATS_SIGMEAN):
        st.mean = float(good.double().sum() / n)
        st.sigma = _sd_t(good)
        st.min = float(good.min())
        st.max = float(good.max())
        st.bgnoise = bgnoise(layer2d)
    if not options & (STATS_BASIC | STATS_MAD | STATS_AVGDEV | STATS_BWMV
                      | STATS_IKSS):
        return st
    st.median = _median_sorted(torch.sort(good).values)
    if options & (STATS_MAD | STATS_BWMV | STATS_IKSS):
        st.mad = _mad_t(good, st.median)
    if options & STATS_AVGDEV:
        st.avgdev = float(torch.abs(good - torch.tensor(
            np.float32(st.median), device=good.device)).double().sum() / n)
    if options & (STATS_BWMV | STATS_IKSS):
        st.sqrtbwmv = float(np.sqrt(_bwmv_t(good, st.mad, st.median)))
    if options & STATS_IKSS:
        # the bounds are Python floats compared with float32 pixels: both
        # packages round them to float32 first
        kept = good[(good >= st.median - 6.0 * st.mad)
                    & (good <= st.median + 6.0 * st.mad)]
        if kept.numel():
            loc = _median_sorted(torch.sort(kept).values)
            m2 = _mad_t(kept, loc)
            if m2 != 0.0:
                st.location = loc
                st.scale = float(np.sqrt(_bwmv_t(kept, m2, loc)) * 0.991)
    return st


def compute_stats_image(img, layer=None, options: int = STATS_MAIN,
                        device=None):
    """Statistics of a SirilImage on ``device`` (``compute_stats_image``
    :254): one layer's, or a list over its layers."""
    from siril_tpu_torch.device import resolve_device

    data = torch.from_numpy(np.ascontiguousarray(img.host())).to(
        resolve_device(device))
    if layer is not None:
        return compute_stats_tensor(data[layer], options)
    return [compute_stats_tensor(data[c], options)
            for c in range(data.shape[0])]


def histogram256(layer2d: torch.Tensor) -> np.ndarray:
    """``np.histogram(layer, bins=256, range=(0, 1))[0]`` of a float32
    layer where it lies.  numpy's edges are float32 (i/256, exact), and
    its bin of x is the i with edges[i] ≤ x < edges[i+1], 1.0 in the last
    bin; x·256 is exact in float32, so that i is floor(x·256) — no
    rounding puts a value on an edge into its neighbour, as
    ``torch.histc`` can."""
    x = layer2d.reshape(-1).float()
    x = x[(x >= 0.0) & (x <= 1.0)]
    idx = torch.clamp(torch.floor(x * 256.0).long(), max=255)
    return torch.bincount(idx, minlength=256).cpu().numpy()
