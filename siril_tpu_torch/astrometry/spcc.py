"""Spectrophotometric colour calibration — counterpart of
``siril_tpu/astrometry/spcc.py`` (src/algos/spcc.c, src/io/spcc_json.c and
the Gaia XP integration of src/io/healpix/xp_*): ``SpectralResponse``,
``builtin_responses``, ``ResponseLibrary``, ``blackbody_sed``,
``expected_fluxes``, ``spcc`` (:133), ``narrowband_filters`` and
``atmospheric_transmission``.

For each matched star, its spectrum S(λ) is integrated against each
channel's response R_c(λ) (sensor QE × filter): f_c = ∫ S(λ) R_c(λ) dλ
over relative photon counts; the white balance is the median of measured
against expected flux ratios, as in ``pcc``.  The spectra are the Gaia XP
sampled spectra of a photometric catalogue
(``astrometry/gaia_local.GaiaXPLocalCatalogue``: xp_sampled records, or
xp_continuous coefficients through the design matrices of
``astrometry/xp_spectra.py``), else a blackbody from the catalogue's B−V.
The response library holds generic built-in curves and reads the
reference's spcc-database JSON files from ``SIRIL_TPU_SPCC_DIR``.  All of
it is host numpy, as in the JAX package, but the final apply, which runs
on ``device`` in float64 as ``pcc``'s does.  The cone is a full field
width about the centre, as in the JAX package (spcc.py:159-162).
"""

from __future__ import annotations

import json
import logging
import os
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from siril_tpu_torch.core.image import SirilImage
from siril_tpu_torch.device import DeviceLike

_log = logging.getLogger(__name__)

# default wavelength grid (nm) — Gaia XP sampled range
WL = np.arange(336.0, 1021.0, 2.0)

_H = 6.62607015e-34
_C = 2.99792458e8
_KB = 1.380649e-23


@dataclass
class SpectralResponse:
    name: str
    wavelength: np.ndarray      # nm
    values: np.ndarray

    def resampled(self, wl: np.ndarray = WL) -> np.ndarray:
        return np.interp(wl, self.wavelength, self.values, left=0.0,
                         right=0.0)

    @staticmethod
    def from_json(path: str) -> "SpectralResponse":
        with open(path) as f:
            d = json.load(f)
        name = d.get("name", os.path.basename(path))
        wl = d.get("wavelength", {})
        vals = d.get("values", {})
        wl_v = np.asarray(wl.get("value", wl) if isinstance(wl, dict) else wl,
                          float)
        va_v = np.asarray(vals.get("value", vals) if isinstance(vals, dict)
                          else vals, float)
        # µm or Å → nm heuristics
        if wl_v.max() < 10.0:
            wl_v = wl_v * 1000.0
        elif wl_v.max() > 3000.0:
            wl_v = wl_v / 10.0
        return SpectralResponse(name, wl_v, va_v)


def builtin_responses() -> Dict[str, SpectralResponse]:
    """Generic built-in curves (typical CMOS QE + RGB dye filters) so
    SPCC works out of the box; JSON files override/extend these."""
    wl = WL

    def gauss(mu, sig, amp=1.0):
        return amp * np.exp(-0.5 * ((wl - mu) / sig) ** 2)

    qe = np.clip(0.9 * np.exp(-0.5 * ((wl - 530) / 220.0) ** 2), 0, 1)
    return {
        "generic_qe": SpectralResponse("generic_qe", wl, qe),
        "R": SpectralResponse("R", wl, gauss(600, 45)),
        "G": SpectralResponse("G", wl, gauss(530, 40)),
        "B": SpectralResponse("B", wl, gauss(460, 40)),
        "UVIR_cut": SpectralResponse(
            "UVIR_cut", wl,
            ((wl > 390) & (wl < 690)).astype(float)),
    }


class ResponseLibrary:
    """spcc_json.c equivalent: load all curves from a directory."""

    def __init__(self, directory: Optional[str] = None):
        self.curves = builtin_responses()
        d = directory or os.environ.get("SIRIL_TPU_SPCC_DIR")
        if d and os.path.isdir(d):
            for f in os.listdir(d):
                if f.endswith(".json"):
                    try:
                        r = SpectralResponse.from_json(os.path.join(d, f))
                        self.curves[r.name] = r
                    except (ValueError, KeyError, json.JSONDecodeError):
                        pass

    def names(self) -> List[str]:
        return sorted(self.curves)

    def get(self, name: str) -> SpectralResponse:
        if name not in self.curves:
            raise KeyError(f"unknown spectral curve '{name}'")
        return self.curves[name]


def blackbody_sed(teff: float, wl: np.ndarray = WL) -> np.ndarray:
    """Planck photon-flux spectrum, peak-normalized."""
    lam = wl * 1e-9
    with np.errstate(over="ignore"):
        b = 1.0 / (lam ** 4 * (np.exp(_H * _C / (lam * _KB * teff)) - 1.0))
    return b / b.max()


def expected_fluxes(sed: np.ndarray, responses: List[np.ndarray],
                    wl: np.ndarray = WL) -> np.ndarray:
    """∫ S(λ)·R_c(λ) dλ per channel (photon counting grid)."""
    return np.array([np.trapezoid(sed * r, wl) for r in responses])


def spcc(img: SirilImage, catalog, wcs=None,
         sensor: str = "generic_qe",
         filters: Tuple[str, str, str] = ("R", "G", "B"),
         library: Optional[ResponseLibrary] = None,
         mag_limit: float = 13.0,
         extra_responses=None, atmosphere=None,
         device: DeviceLike = None,
         stages: Optional[dict] = None) -> Optional[SirilImage]:
    """``spcc``: a plate-solved RGB image and a catalogue with Gaia XP
    spectra (or B−V, through a blackbody); ``stages`` receives the seconds
    of the host photometry (the cone, the spectra, the stars, K and the
    medians) and of the device apply."""
    t = time.perf_counter()
    from siril_tpu_torch.astrometry.pcc import (
        apply_gains,
        bv_to_temp,
        field_cone,
        layer_median,
        star_fluxes,
    )
    from siril_tpu_torch.ops.statistics import per_layer

    if img.nchans != 3:
        raise ValueError("SPCC requires an RGB image")
    w = wcs or img.wcs
    if w is None:
        raise ValueError("SPCC requires a plate-solved image")
    lib = library or ResponseLibrary()
    qe = lib.get(sensor).resampled()
    if extra_responses is not None:
        # synthesized narrowband responses replace the filter curves
        resp = [r * qe for r in extra_responses]
    else:
        resp = [lib.get(f).resampled() * qe for f in filters]
    if atmosphere is not None:
        resp = [r * atmosphere for r in resp]
    H, W = img.height, img.width
    cone = field_cone(img, w, catalog, mag_limit)
    if len(cone) < 5:
        _log.error("SPCC: not enough catalogue stars in field")
        return None
    bv = cone.bv if cone.bv is not None else np.full(len(cone), 0.65)
    # Gaia XP sampled spectra (N, 343) in W·m⁻²·nm⁻¹, as relative photon
    # counts (spcc.c:99 flux_to_relcount)
    xp = getattr(cone, "xp_sampled", None)
    if xp is not None:
        from siril_tpu_torch.astrometry.xp_spectra import flux_to_relcount

        xp = flux_to_relcount(xp)
    data = img.host()
    ratios = []
    for k, fluxes in star_fluxes(data, cone, w, H, W):
        sed = xp[k] if xp is not None else \
            blackbody_sed(bv_to_temp(float(bv[k])))
        exp = expected_fluxes(sed, resp)
        if exp.min() <= 0:
            continue
        ratios.append((fluxes, exp))
    if len(ratios) < 4:
        _log.error("SPCC: only %d usable stars", len(ratios))
        return None
    kws = []
    for c in range(3):
        vals = [(e[c] / e[1]) / (f[c] / f[1]) for f, e in ratios]
        kws.append(float(np.median(vals)))
    kw = np.array(kws)
    kw /= kw[1]
    bg = np.array(per_layer(layer_median, data))
    offset = -bg * kw + bg.mean()
    if stages is not None:
        stages["photometry"] = time.perf_counter() - t
    res = img.copy(data=apply_gains(img, kw, offset, device, stages))
    res.wcs = img.wcs
    res.log_history(f"SPCC ({len(ratios)} stars, sensor {sensor})")
    _log.info("SPCC white balance: K=[%.3f %.3f %.3f] from %d stars",
              kw[0], kw[1], kw[2], len(ratios))
    return res


def narrowband_filters(rwl: float = 656.28, gwl: float = 500.7,
                       bwl: float = 500.7, rbw: float = 3.0,
                       gbw: float = 3.0, bbw: float = 3.0):
    """Synthesize top-hat narrowband filter responses (spcc -narrowband
    -rwl/-gwl/-bwl/-rbw/-gbw/-bbw flags)."""
    out = []
    for wl0, bw in ((rwl, rbw), (gwl, gbw), (bwl, bbw)):
        v = ((WL >= wl0 - bw / 2.0) & (WL <= wl0 + bw / 2.0)).astype(float)
        out.append(v)
    return out


def atmospheric_transmission(obsheight_m: float = 0.0,
                             pressure_mbar: Optional[float] = None,
                             wl: np.ndarray = WL) -> np.ndarray:
    """Rayleigh-dominated atmospheric transmission at zenith (the spcc
    -atmos model: extinction scales with site pressure / altitude).
    τ_R(λ) ≈ 0.00877·(P/P0)·λ_um^-4.05 (Hayes & Latham 1975 form)."""
    p0 = 1013.25
    if pressure_mbar is None:
        # barometric altitude → pressure
        pressure_mbar = p0 * np.exp(-obsheight_m / 8434.0)
    lam_um = wl / 1000.0
    tau = 0.00877 * (pressure_mbar / p0) * lam_um ** -4.05
    return np.exp(-tau)
