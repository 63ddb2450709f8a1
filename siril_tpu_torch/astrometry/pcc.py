"""Photometric colour calibration — counterpart of
``siril_tpu/astrometry/pcc.py`` (src/algos/photometric_cc.c,
apply_photometric_color_correction:811): ``bv_to_temp``, ``planck_xy``,
``bv_to_rgb``, ``photometric_color_calibration`` (:68) and
``background_neutralization`` (:141).

For each plate-solved star with a catalogue B−V, its flux in each channel
(aperture photometry) against the RGB that B−V predicts (Ballesteros
T_eff → Planckian locus xy → XYZ → linear sRGB); the white balance K is
the median ratio a channel, normalised to G; then
  out_c = in_c·K_c + (−bg_c·K_c + mean(bg))
with bg the layers' medians (the background equalization,
photometric_cc.c:811-848).  The star fits and K are host numpy, as in the
JAX package.  The final apply runs on ``device`` (CUDA unless "cpu") in
float64, as numpy computes it there, and rounds once to float32, so that
it is bit-equal to the JAX package's.
"""

from __future__ import annotations

import logging
import time
from typing import Optional, Tuple

import numpy as np
import torch

from siril_tpu_torch.core.image import SirilImage
from siril_tpu_torch.device import DeviceLike, resolve_device
from siril_tpu_torch.ops.statistics import per_layer

_log = logging.getLogger(__name__)

# XYZ → linear sRGB (D65)
_M_XYZ2RGB = np.array([[3.2404542, -1.5371385, -0.4985314],
                       [-0.9692660, 1.8760108, 0.0415560],
                       [0.0556434, -0.2040259, 1.0572252]])


def bv_to_temp(bv: float) -> float:
    """Ballesteros (2012) B−V → T_eff (K)."""
    return 4600.0 * (1.0 / (0.92 * bv + 1.7) + 1.0 / (0.92 * bv + 0.62))


def planck_xy(t: float) -> Tuple[float, float]:
    """Planckian locus approximation (CIE, 1667K–25000K)."""
    t = min(max(t, 1667.0), 25000.0)
    inv = 1000.0 / t
    if t < 4000.0:
        x = (-0.2661239 * inv ** 3 - 0.2343589 * inv ** 2
             + 0.8776956 * inv + 0.179910)
    else:
        x = (-3.0258469 * inv ** 3 + 2.1070379 * inv ** 2
             + 0.2226347 * inv + 0.240390)
    if t < 2222.0:
        y = (-1.1063814 * x ** 3 - 1.34811020 * x ** 2
             + 2.18555832 * x - 0.20219683)
    elif t < 4000.0:
        y = (-0.9549476 * x ** 3 - 1.37418593 * x ** 2
             + 2.09137015 * x - 0.16748867)
    else:
        y = (3.0817580 * x ** 3 - 5.87338670 * x ** 2
             + 3.75112997 * x - 0.37001483)
    return x, y


def bv_to_rgb(bv: float) -> np.ndarray:
    """Expected linear RGB (max-normalized) of a star of given B−V."""
    t = bv_to_temp(bv)
    x, y = planck_xy(t)
    Y = 1.0
    X = x / y * Y
    Z = (1 - x - y) / y * Y
    rgb = _M_XYZ2RGB @ np.array([X, Y, Z])
    rgb = np.maximum(rgb, 1e-6)
    return rgb / rgb.max()


def layer_median(layer: np.ndarray) -> float:
    """Median of a layer's non-zero, non-NaN pixels (``compute_stats_np``'s
    ``median``, the only field that the calibrations read)."""
    good = layer.ravel()
    good = good[(good != 0.0) & ~np.isnan(good)]
    return float(np.median(good)) if good.size else 0.0


def star_fluxes(data: np.ndarray, cone, w, H: int, W: int):
    """[(k, fluxes)]: the cone's stars at least 15 px inside the frame
    whose aperture flux (r = 5 px, sky 8-12 px) is positive in every
    channel, by their index in the cone."""
    from siril_tpu_torch.ops.photometry import PhotConfig, measure_star

    x, y = w.world2pix(cone.ra, cone.dec)
    cfg = PhotConfig(inner=8.0, outer=12.0, force_radius=True, aperture=5.0)
    out = []
    for k in range(len(cone)):
        if not (15 < x[k] < W - 15 and 15 < y[k] < H - 15):
            continue
        fluxes = []
        for c in range(3):
            r = measure_star(data[c], float(x[k]), float(y[k]), 4.0, cfg)
            if not r.intensity or r.intensity <= 0:
                break
            fluxes.append(r.intensity)
        else:
            out.append((k, np.array(fluxes)))
    return out


def gains_tensor(x: torch.Tensor, kw, offset) -> torch.Tensor:
    """clip(x·K + offset, 0, 1) of a (C, H, W) float32 tensor, computed in
    float64 and rounded once to float32."""
    dev = x.device
    k = torch.from_numpy(np.asarray(kw, np.float64)).to(dev)[:, None, None]
    o = torch.from_numpy(np.asarray(offset, np.float64)).to(dev)[:, None,
                                                                 None]
    return torch.clamp(x.double() * k + o, 0.0, 1.0).float()


def apply_gains(img: SirilImage, kw: np.ndarray, offset: np.ndarray,
                device: DeviceLike = None,
                stages: Optional[dict] = None) -> np.ndarray:
    """``gains_tensor`` of the image on ``device``, fetched; its seconds
    (upload, apply, fetch) in ``stages["apply"]``."""
    t = time.perf_counter()
    x = torch.from_numpy(img.host()).to(resolve_device(device))
    out = np.ascontiguousarray(gains_tensor(x, kw, offset).cpu().numpy())
    if stages is not None:
        stages["apply"] = time.perf_counter() - t
    return out


def field_cone(img: SirilImage, w, catalog, mag_limit: float,
               radius_scale: float = 1.0):
    """The catalogue's stars within a full field width (× radius_scale)
    of the image centre under ``w``."""
    H, W = img.height, img.width
    fov = w.pixel_scale_arcsec * max(H, W) / 3600.0
    ra_c, dec_c = w.pix2world(np.array([W / 2.0]), np.array([H / 2.0]))
    return catalog.cone_search(float(ra_c[0]), float(dec_c[0]),
                               fov * radius_scale, mag_limit)


def photometric_color_calibration(img: SirilImage, catalog,
                                  wcs=None, mag_limit: float = 13.0,
                                  bg_tolerance: float = 2.0,
                                  device: DeviceLike = None,
                                  stages: Optional[dict] = None
                                  ) -> Optional[SirilImage]:
    """``pcc``: a plate-solved RGB image and a catalogue with B−V;
    ``stages`` receives the seconds of the host photometry (the cone, the
    stars, K and the medians) and of the device apply."""
    t = time.perf_counter()
    if img.nchans != 3:
        raise ValueError("PCC requires an RGB image")
    w = wcs or img.wcs
    if w is None:
        raise ValueError("PCC requires a plate-solved image (run platesolve)")
    if getattr(catalog, "bv", None) is None:
        raise ValueError("catalogue has no B-V color data")
    H, W = img.height, img.width
    cone = field_cone(img, w, catalog, mag_limit)
    cone_bv = cone.bv if cone.bv is not None else np.full(len(cone), 0.65)
    if len(cone) < 5:
        _log.error("PCC: not enough catalogue stars in field")
        return None
    data = img.host()
    ratios = []
    for k, fluxes in star_fluxes(data, cone, w, H, W):
        expected = bv_to_rgb(float(cone_bv[k]) if k < len(cone_bv)
                             else 0.65)
        ratios.append((fluxes, expected))
    if len(ratios) < 4:
        _log.error("PCC: only %d usable stars", len(ratios))
        return None
    # kw_c = median over the stars of (expected_c/expected_G) /
    # (flux_c/flux_G)
    kws = []
    for c in range(3):
        vals = [(e[c] / e[1]) / (f[c] / f[1]) for f, e in ratios
                if f[1] > 0 and e[1] > 0]
        kws.append(float(np.median(vals)))
    kw = np.array(kws)
    kw /= kw[1]
    bg = np.array(per_layer(layer_median, data), np.float32)
    bg_mean = float(bg.mean())
    offset = -bg * kw + bg_mean
    if stages is not None:
        stages["photometry"] = time.perf_counter() - t
    res = img.copy(data=apply_gains(img, kw, offset, device, stages))
    res.wcs = img.wcs
    res.log_history(
        f"PCC ({len(ratios)} stars, K=[{kw[0]:.3f} {kw[1]:.3f} {kw[2]:.3f}])")
    _log.info("PCC white balance: K0=%.3f K1=%.3f K2=%.3f from %d stars",
              kw[0], kw[1], kw[2], len(ratios))
    return res


def background_neutralization(img: SirilImage, device: DeviceLike = None,
                              stages: Optional[dict] = None) -> SirilImage:
    """``bgneutralize``: every layer's median moved to their mean."""
    t = time.perf_counter()
    data = img.host()
    bg = np.array(per_layer(layer_median, data))
    if stages is not None:
        stages["medians"] = time.perf_counter() - t
    res = img.copy(data=apply_gains(img, np.ones(img.nchans),
                                    bg.mean() - bg, device, stages))
    res.log_history("Background neutralization")
    return res
