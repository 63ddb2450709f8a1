"""Star detection — counterpart of ``siril_tpu/registration/starfinder.py``
(``StarFinderParams``:36, ``detect_stars``:120, ``detection_radius``:293,
``_stats_cand_fit_fn``:305 with ``_candidate_fn``:53, ``detect_stars_batch``
:367, ``_filter_and_dedup``:186 and ``save_star_list_csv``:529).

``detect_stars`` (one layer, the staged ``register``) thresholds at the
STATS_BASIC median + σ·background noise, as the reference's per-frame
path; the batched path (``fusedstack``, ``register -2pass/-noout``) at
median + σ·1.4826·MAD.

Per frame on the device: median/MAD detection statistics, threshold
``bg + σ·noise``, local maxima of a separable (2r+1)² max-pool above it,
per-cell argmax compaction, top-K candidates, and one batched LM PSF fit
of their patches.  On the host: a second fit of blended candidates on
smaller crops, quality filters and the minimum-separation dedup.  The
batched path's device part runs as the spans ``fused.detect.stats``,
``.candidates`` and ``.fit``; the counters ``detect.candidates``,
``detect.refits`` and ``detect.stars`` count the finite candidates
fitted, the blended refits and the stars kept (``utils/trace.py``).

Max-pooling is exact in any precision (no TF32 involved).  ``torch.topk``
may order tied candidates differently from ``lax.top_k``: star lists are
compared by position, not by index.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from siril_tpu_torch.ops.rejection import fma
from siril_tpu_torch.ops.statistics import compute_stats_basic, median_rows
from siril_tpu_torch.registration.psf import (
    PROFILE_GAUSSIAN,
    PSFStar,
    _Fitter,
    fit_dict_from_packed,
    fit_psf_batch,
    stars_from_fit,
)
from siril_tpu_torch.utils.trace import count, stage


@dataclass
class StarFinderParams:
    """star_finder_params (settings.h:296-308) defaults."""

    radius: int = 10
    sigma: float = 1.0
    roundness: float = 0.5
    convergence: int = 1
    relax_checks: bool = False
    profile: int = PROFILE_GAUSSIAN
    min_beta: float = 1.5
    min_A: float = 0.0
    max_A: float = 0.0           # 0 = no bound
    max_r: float = 1.0
    max_stars: int = 2000


def detection_radius(H: int, W: int,
                     params: Optional[StarFinderParams] = None) -> int:
    """The candidate-search radius used for an (H, W) layer."""
    p = params or StarFinderParams()
    R = int(p.radius)
    box = 2 * R + 1
    if H < 4 * box or W < 4 * box:
        R = max(min(H, W) // 8, 3)
    return R


def _candidates(x: torch.Tensor, thr: torch.Tensor, r: int, k: int):
    """Top-k local maxima above ``thr`` of one (H, W) layer → (values,
    flat indices); missing candidates have value −inf."""
    Himg, Wimg = x.shape
    w = 2 * r + 1
    mp = F.max_pool2d(x[None, None], (w, 1), stride=1, padding=(r, 0))
    mp = F.max_pool2d(mp, (1, w), stride=1, padding=(0, r))[0, 0]
    yy = torch.arange(Himg, device=x.device)[:, None]
    xx = torch.arange(Wimg, device=x.device)[None, :]
    inb = (yy >= r) & (yy < Himg - r) & (xx >= r) & (xx < Wimg - r)
    resp = torch.where((x >= mp) & (x > thr) & inb, x, float("-inf"))
    # per-cell argmax compaction: two distinct local maxima of a (2r+1)²
    # window are > r apart, so an (r+1)² cell holds at most one
    c = r + 1
    ncy, ncx = -(-Himg // c), -(-Wimg // c)
    if Himg * Wimg >= 1 << 22 and ncy * ncx >= k:
        padded = F.pad(resp, (0, ncx * c - Wimg, 0, ncy * c - Himg),
                       value=float("-inf"))
        cells = padded.reshape(ncy, c, ncx, c).permute(0, 2, 1, 3).reshape(
            ncy * ncx, c * c)
        sub_v, sub_i = cells.max(dim=-1)
        ci = torch.arange(ncy * ncx, device=x.device)
        by = (ci // ncx) * c + sub_i // c
        bx = (ci % ncx) * c + sub_i % c
        v, j = torch.topk(sub_v, k)
        return v, torch.clamp(by * Wimg + bx, 0, Himg * Wimg - 1)[j]
    return torch.topk(resp.reshape(-1), k)


def _patches(x: torch.Tensor, y0: torch.Tensor, x0: torch.Tensor,
             b: int) -> torch.Tensor:
    """(k, b, b) patches of the (H, W) layer at origins (y0, x0)."""
    off = torch.arange(b, device=x.device)
    return x[(y0[:, None] + off)[:, :, None], (x0[:, None] + off)[:, None, :]]


def stats_cand_fit(frames: torch.Tensor, r: int, k: int, sigma: float,
                   profile: int):
    """The whole per-frame device part of detection for a chunk of
    (n, H, W) layers: stats [3, n] (median, 1.4826·MAD, max over finite
    pixels), candidate values and flat indices [n, k], packed PSF fits
    [n, k, npar+1]."""
    n, H, W = frames.shape
    box = 2 * r + 1
    fitter = _Fitter(box, profile)
    with stage("fused.detect.stats"):
        flat = frames.reshape(n, -1)
        valid = torch.isfinite(flat)
        med = median_rows(flat, valid)
        mad = median_rows(torch.abs(flat - med[:, None]), valid)
        noise = 1.4826 * mad
        stats = torch.stack([med, noise, flat.max(dim=1).values])
        thrs = fma(float(np.float32(sigma)), torch.clamp_min(noise, 1e-7),
                   med)
    vals, idxs, fits = [], [], []
    for f in range(n):
        with stage("fused.detect.candidates"):
            v, i = _candidates(frames[f], thrs[f], r, k)
            y0 = torch.clamp(i // W - r, 0, H - box)
            x0 = torch.clamp(i % W - r, 0, W - box)
            vals.append(v)
            idxs.append(i)
        with stage("fused.detect.fit"):
            fits.append(fitter(_patches(frames[f], y0, x0, box)))
    return stats, torch.stack(vals), torch.stack(idxs), torch.stack(fits)


def detect_stars(layer: torch.Tensor,
                 params: Optional[StarFinderParams] = None,
                 max_stars: Optional[int] = None) -> List[PSFStar]:
    """peaker() on one (H, W) layer on its device; stars brightest first."""
    p = params or StarFinderParams()
    K = int(max_stars or p.max_stars)
    H, W = layer.shape
    R = detection_radius(H, W, p)
    box = 2 * R + 1
    with stage("sf.stats"):
        st = compute_stats_basic(layer)
        bg, noise = st.median, st.bgnoise
        thr = bg + p.sigma * max(noise, 1e-7)
    dev = layer.device
    with stage("sf.candidates"):
        vals, idx = _candidates(layer, torch.tensor(np.float32(thr),
                                                    device=dev),
                                R, min(K, H * W))
        vals = vals.cpu().numpy()
        idx = idx.cpu().numpy()
    n_cand = int((vals > -np.inf).sum())
    count("detect.candidates", n_cand)
    if n_cand == 0:
        return []
    y0s = np.clip(idx[:n_cand] // W - R, 0, H - box)
    x0s = np.clip(idx[:n_cand] % W - R, 0, W - box)
    with stage("sf.psf_fit"):
        patches = _patches(layer, torch.as_tensor(y0s, device=dev),
                           torch.as_tensor(x0s, device=dev), box)
        stars = stars_from_fit(fit_psf_batch(patches, profile=p.profile),
                               x0s, y0s, box, p.profile)

    def crop(sel, off, small):
        return patches[torch.as_tensor(sel, device=dev)][
            :, off:off + small, off:off + small]

    with stage("sf.mkstars"):
        _refit_blended(stars, x0s, y0s, box, p, crop)
    with stage("sf.dedup"):
        out = _filter_and_dedup(stars, x0s, y0s, R, box, p, noise,
                                float(layer.max()))
    count("detect.stars", len(out))
    return out


def _refit_blended(stars, x0s, y0s, box, p, crop,
                   cap: Optional[int] = None) -> None:
    """Second chance for blended fits, in place: a neighbour inside the
    box elongates the profile, so a star whose fit is not round enough or
    too wide is refitted on a smaller crop centred on its candidate peak,
    and the refit replaces it where it is rounder.  ``crop(sel, off,
    small)`` gathers the (len(sel), small, small) patches at offset
    ``off`` in the boxes of the candidates ``sel`` (ascending); ``cap``
    keeps the brightest that many."""
    if box < 13:
        return
    retry = [i for i, s in enumerate(stars)
             if np.isfinite(s.fwhmx) and
             (s.roundness < p.roundness or s.fwhmx > box / 2)]
    if cap is not None and len(retry) > cap:
        retry = sorted(sorted(retry, key=lambda i: -stars[i].A)[:cap])
    if not retry:
        return
    count("detect.refits", len(retry))
    small = ((box // 2) // 2) * 2 + 1
    off = (box - small) // 2
    ridx = np.asarray(retry)
    stars2 = stars_from_fit(fit_psf_batch(crop(ridx, off, small),
                                          profile=p.profile),
                            x0s[ridx] + off, y0s[ridx] + off, small,
                            p.profile)
    for k, i in enumerate(retry):
        s2 = stars2[k]
        if s2.roundness > stars[i].roundness and 0.5 < s2.fwhmx <= small:
            stars[i] = s2


def _filter_and_dedup(stars, x0s, y0s, R, box, p, noise, sat):
    """Quality filters + min-separation dedup (minimize_candidates checks,
    star_finder.c:569), brightest kept."""
    if not stars:
        return []
    cols = np.array([(s.A, s.B, s.x0, s.y0, s.fwhmx, s.fwhmy,
                      s.roundness, s.rmse) for s in stars], np.float64)
    A, B, sx, sy, fx, fy, rnd, rmse = cols.T
    with np.errstate(invalid="ignore"):
        ok = np.isfinite(cols).all(axis=1)
        ok &= (A >= 1e-5) & (A >= 5.0 * noise)
        if p.min_A:
            ok &= A >= p.min_A
        if p.max_A:
            ok &= A <= p.max_A
        ok &= (fx > 0.5) & (fy > 0.5) & (fx <= box)
        if not p.relax_checks:
            ok &= rnd >= p.roundness
            ok &= rmse <= 0.1 * (A + 1e-9) + 0.05
        cx = np.asarray(x0s, np.float64) + R
        cy = np.asarray(y0s, np.float64) + R
        ok &= (np.abs(sx - cx) <= R) & (np.abs(sy - cy) <= R)
    idx = np.nonzero(ok)[0]
    if idx.size == 0:
        return []
    for i in idx:
        stars[i].has_saturated = A[i] + B[i] >= 0.98 * sat
    order = idx[np.argsort(-A[idx], kind="stable")]
    min_d2 = (R * 0.5) ** 2
    out: List[PSFStar] = []
    ax = np.empty(order.size)
    ay = np.empty(order.size)
    nacc = 0
    for i in order:
        if nacc == 0 or (((sx[i] - ax[:nacc]) ** 2
                          + (sy[i] - ay[:nacc]) ** 2) >= min_d2).all():
            ax[nacc] = sx[i]
            ay[nacc] = sy[i]
            nacc += 1
            out.append(stars[i])
    return out


def detect_stars_batch(chunks: Sequence[torch.Tensor],
                       params: Optional[StarFinderParams],
                       max_stars: int, precomputed) -> List[List[PSFStar]]:
    """Finish detection for the frames held as a list of (n_i, H, W)
    device chunks, from the per-chunk ``stats_cand_fit`` outputs
    concatenated over frames (host numpy arrays).  Returns one star list
    per frame, brightest first."""
    p = params or StarFinderParams()
    N = sum(int(c.shape[0]) for c in chunks)
    H, W = (int(d) for d in chunks[0].shape[-2:])
    R = detection_radius(H, W, p)
    box = 2 * R + 1
    stats, vals, idx, fits_h = precomputed
    noises, sats = np.maximum(stats[1], 1e-7), stats[2]
    fi, ki = np.nonzero(vals > -np.inf)
    count("detect.candidates", fi.size)
    if fi.size == 0:
        return [[] for _ in range(N)]
    cy = (idx[fi, ki] // W).astype(np.int64)
    cx = (idx[fi, ki] % W).astype(np.int64)
    y0s = np.clip(cy - R, 0, H - box)
    x0s = np.clip(cx - R, 0, W - box)
    fit = fit_dict_from_packed(fits_h[fi, ki], p.profile)
    stars = stars_from_fit(fit, x0s, y0s, box, p.profile)

    def crop(ridx, off, small):
        rfi = fi[ridx]                 # ridx ascending, so frame-grouped
        parts, base = [], 0
        for ch in chunks:
            for f in np.unique(rfi[(rfi >= base) &
                                   (rfi < base + ch.shape[0])]):
                sel = ridx[rfi == f]
                dev = ch.device
                parts.append(_patches(
                    ch[int(f) - base],
                    torch.as_tensor(y0s[sel] + off, device=dev),
                    torch.as_tensor(x0s[sel] + off, device=dev), small))
            base += ch.shape[0]
        return torch.cat(parts)

    _refit_blended(stars, x0s, y0s, box, p, crop, cap=4096)
    out: List[List[PSFStar]] = []
    for f in range(N):
        sel = np.nonzero(fi == f)[0]
        out.append(_filter_and_dedup(
            [stars[i] for i in sel], x0s[sel], y0s[sel], R, box, p,
            float(noises[f]), float(sats[f])))
    count("detect.stars", sum(len(o) for o in out))
    return out


def save_star_list_csv(stars: List[PSFStar], path: str) -> None:
    """Star list persistence (star_finder.c:933 CSV writer)."""
    import csv

    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["x", "y", "FWHMx", "FWHMy", "angle", "A", "B",
                    "roundness", "rmse", "beta"])
        for s in stars:
            w.writerow([f"{s.x0:.3f}", f"{s.y0:.3f}", f"{s.fwhmx:.3f}",
                        f"{s.fwhmy:.3f}", f"{s.angle:.2f}", f"{s.A:.5f}",
                        f"{s.B:.5f}", f"{s.roundness:.3f}",
                        f"{s.rmse:.5f}", f"{s.beta:.2f}"])
