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

The sequence photometry — ``seq_photometry`` (:137, seqpsf),
``light_curve`` (:204) and ``save_aavso_extended`` (:258) — reads a strip
of each frame around the star, follows it through the registration or
from frame to frame, and fits it with the batched LM fitter on the
device; the photometry itself stays host numpy.  A frame's window depends
on the previous frame's fit, so the frames are fitted one after another;
the light curve's stars go through the fitter together, frame by frame
(``seq_photometry_stars``).  The light curve's PNG companion
(``utils/splot.SirilPlot``) is not ported (ROADMAP §1.7): the ``.dat``,
the AAVSO ``.csv`` and the log are the result.
"""

from __future__ import annotations

import logging
import math
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from siril_tpu_torch.device import DeviceLike, resolve_device

_log = logging.getLogger(__name__)

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


def image_gain(kw) -> Optional[float]:
    """The frame's CVF card (e-/ADU), or None; the port keeps it in
    ``Keywords.extra``."""
    try:
        return float(kw.extra.get("CVF", 0.0) or 0.0) or None
    except (TypeError, ValueError):
        return None


def seq_photometry(seq, x0: float, y0: float, layer: int = 0,
                   cfg: Optional[PhotConfig] = None, follow: bool = True,
                   box: int = 30, device: DeviceLike = None):
    """seqpsf / light-curve core (``seq_photometry``:137): on every
    selected frame, an LM fit of a ``box``² patch around the star near
    (x0, y0) — through the frame's registration when it has one, else
    where the previous frame's fit put it (``follow``) — then aperture
    photometry at the fitted centre.  [(index, None | {phot, x, y, fwhm,
    date_obs})]."""
    return seq_photometry_stars(seq, [(x0, y0)], layer, cfg, follow, box,
                                device)[0]


def seq_photometry_stars(seq, xys, layer: int = 0,
                         cfg: Optional[PhotConfig] = None,
                         follow: bool = True, box: int = 30,
                         device: DeviceLike = None):
    """``seq_photometry`` of several stars, frame by frame: each star
    follows its own fits as alone, and a frame's patches go through the
    LM fitter in one batch (its rows are fitted independently, so each
    star's fit is the one it would get alone).  A list per star."""
    from siril_tpu_torch.registration.psf import fit_psf_batch, fwhm_from_s

    dev = resolve_device(device)
    cfg = cfg or PhotConfig()
    results = [[] for _ in xys]
    cur = [tuple(xy) for xy in xys]
    # partial-window reads: a strip around each star covering the fit box
    # and the sky annulus
    strip = box + 2 * int(np.ceil(cfg.outer)) + 8
    H, W = seq.ry, seq.rx
    use_partial = H > 2 * strip and seq.rx > 0
    for idx in seq.selected_indices():
        img, kw = None, None
        if not use_partial:
            img = seq.read_frame(int(idx))
            full = img.host()[min(layer, img.nchans - 1)]
            H, W = full.shape
        todo = []
        for k, (x0, y0) in enumerate(xys):
            tx, ty = x0, y0
            if layer in seq.regparam and seq.regparam[layer].valid[idx]:
                Hm = np.linalg.inv(seq.regparam[layer].H[idx])
                v = Hm @ np.array([x0, y0, 1.0])
                tx, ty = v[0] / v[2], v[1] / v[2]
            elif follow:
                tx, ty = cur[k]
            bx = int(np.clip(tx - box // 2, 0, max(W - box, 0)))
            by = int(np.clip(ty - box // 2, 0, max(H - box, 0)))
            row0, lay = 0, None if use_partial else full
            if use_partial:
                row0 = int(np.clip(ty - strip // 2, 0, max(H - strip, 0)))
                try:
                    lay = seq.read_region(
                        min(layer, max(seq.nb_layers - 1, 0)), int(idx),
                        row0, row0 + strip)
                except (ValueError, OSError):
                    if img is None:
                        img = seq.read_frame(int(idx))
                    lay = img.host()[min(layer, img.nchans - 1)]
                    row0 = 0
            patch = lay[by - row0:by - row0 + box, bx:bx + box]
            if patch.shape != (box, box):
                results[k].append((int(idx), None))
                continue
            todo.append((k, bx, by, row0, lay, patch))
        if not todo:
            continue
        fit = fit_psf_batch(torch.from_numpy(np.ascontiguousarray(
            np.stack([t[5] for t in todo]), np.float32)).to(dev))
        fwhm = fwhm_from_s(fit["sx"], fit["beta"])
        if kw is None:
            kw = (img.keywords if img is not None
                  else seq.read_frame_metadata(int(idx)))
        for r, (k, bx, by, row0, lay, _) in enumerate(todo):
            fx = float(fwhm[r])
            sx0 = bx + float(fit["x0"][r])
            sy0 = by + float(fit["y0"][r])
            if follow:
                cur[k] = (sx0, sy0)
            phot = measure_star(lay, sx0, sy0 - row0, fx, cfg,
                                image_gain(kw))
            results[k].append((int(idx), {"phot": phot, "x": sx0,
                                          "y": sy0, "fwhm": fx,
                                          "date_obs": kw.date_obs}))
    return results


def light_curve(seq, target_xy: Tuple[float, float],
                comp_xys: Sequence[Tuple[float, float]], layer: int = 0,
                cfg: Optional[PhotConfig] = None,
                out_path: str = "light_curve.dat",
                device: DeviceLike = None):
    """light_curve (photometry.c light_curve_worker:593): the target's
    magnitude less the mean of the comparison stars', frame by frame,
    with the errors added in quadrature; written to ``out_path``."""
    cfg = cfg or PhotConfig()
    tgt, *comps = seq_photometry_stars(seq, [target_xy] + list(comp_xys),
                                       layer=layer, cfg=cfg, device=device)
    rows = []
    for k, (idx, t) in enumerate(tgt):
        if t is None or not t["phot"].valid:
            continue
        cmags = []
        cerr = []
        for comp in comps:
            _, c = comp[k]
            if c is not None and c["phot"].valid:
                cmags.append(c["phot"].mag)
                cerr.append(c["phot"].s_mag ** 2)
        if not cmags:
            continue
        ref_mag = float(np.mean(cmags))
        vmag = t["phot"].mag - ref_mag
        err = math.sqrt(t["phot"].s_mag ** 2 + np.mean(cerr))
        rows.append((idx, t["date_obs"] or "", vmag, err))
    with open(out_path, "w") as f:
        f.write("# frame date_obs rel_mag err\n")
        for r in rows:
            f.write(f"{r[0]} {r[1]} {r[2]:.5f} {r[3]:.5f}\n")
    if rows:
        _log.info("light curve: no PNG companion (siril_plot is not "
                  "ported)")
    return rows


def save_aavso_extended(rows, out_path: str, starid: str = "object",
                        obscode: str = "XXX", filt: str = "V",
                        chart: str = "na", cname: str = "ENSEMBLE",
                        kname: str = "na", notes: str = "na") -> int:
    """AAVSO extended file format writer (io/aavso_extended.c:40-52):
    one row per light-curve point, DATE the Julian date of DATE-OBS."""
    from siril_tpu_torch.utils.dates import date_obs_to_julian

    n = 0
    with open(out_path, "w") as f:
        f.write("#TYPE=EXTENDED\n")
        f.write(f"#OBSCODE={obscode}\n")
        f.write("#SOFTWARE=siril_tpu\n")
        f.write("#DELIM=,\n")
        f.write("#DATE=JD\n")
        f.write("#OBSTYPE=CCD\n")
        f.write("#NAME,DATE,MAG,MERR,FILT,TRANS,MTYPE,CNAME,CMAG,KNAME,"
                "KMAG,AMASS,GROUP,CHART,NOTES\n")
        for frame, date_obs, mag, err in rows:
            jd = date_obs_to_julian(date_obs) if date_obs else None
            date = f"{jd:.5f}" if jd else "na"
            f.write(f"{starid},{date},{mag:.3f},{err:.3f},{filt},NO,STD,"
                    f"{cname},na,{kname},na,na,na,{chart},{notes}\n")
            n += 1
    return n
