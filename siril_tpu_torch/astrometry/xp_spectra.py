"""Gaia DR3 XP continuous → sampled spectra for SPCC — counterpart of
``siril_tpu/astrometry/xp_spectra.py`` (src/io/healpix/xp_continuous.cpp,
tools/bake_xp_design.py, src/io/healpix/gaia_xp_design.c), host numpy and
scipy as in the JAX package:

1. **Bake** (once per instrument model): per-band design matrices
   D[nbases, 343] on the Siril sampling grid (336..1020 nm, step 2 nm)
   from the GaiaXPy instrument-model CSVs (Hermite-function bases, the
   dispersion spline, the response normalisation), and the BP/RP merge
   weights (``bake_design``).
2. **Runtime** (a GEMV a source): ``flux[i] = Σ_k bp_c[k]·D_bp[k,i]·w_bp[i]
   + Σ_k rp_c[k]·D_rp[k,i]·w_rp[i]`` with float64 sums over float32
   coefficients (``xpcts_to_xpsampled``, xp_continuous.cpp:15-49).

``load_design`` reads a baked ``.npz``, a reference-format
``gaia_xp_design.c`` or a GaiaXPy configuration directory, from an explicit
path or ``SIRIL_TPU_XP_DESIGN``.  The real instrument-model CSVs are not
in the repository; ``synthetic_design`` runs the same bake on a small
synthetic instrument (``synthetic_instrument_model``).
"""

from __future__ import annotations

import os
import re
from typing import Dict, Optional, Tuple

import numpy as np

# Siril xp_sampled grid (spcc.c:41 xpsampled_wl)
SAMPLING = np.arange(336.0, 1021.0, 2.0)
XPSAMPLED_LEN = 343
XPCTS_NBASES = 55
assert len(SAMPLING) == XPSAMPLED_LEN

# physical constants (GaiaXPy nature/satellite modules)
C_LIGHT = 2.99792458e8
PLANCK = 6.62607004e-34
TELESCOPE_PUPIL_AREA = 0.7278
HC_NM = 1.0e9 * C_LIGHT * PLANCK
# BP/RP merge band edges (calibrator merge: linear crossfade 635..643 nm)
BP_WL_HIGH = 643.0
RP_WL_LOW = 635.0

XPCTS_USE_HINT = -1


# ---------------------------------------------------------------------------
# Hermite functions (orthonormal physicist's form, stable recurrence)
# ---------------------------------------------------------------------------


def hermite_functions(n_max: int, x: np.ndarray) -> np.ndarray:
    """ψ_0..ψ_{n_max−1} evaluated at x, shape (n_max, len(x)).

    ψ_0 = π^{-1/4} e^{-x²/2};  ψ_1 = √2·x·ψ_0;
    ψ_n = √(2/n)·x·ψ_{n−1} − √((n−1)/n)·ψ_{n−2}
    """
    x = np.asarray(x, np.float64)
    out = np.empty((n_max, x.size), np.float64)
    g = np.exp(-0.5 * x * x) * np.pi ** -0.25
    out[0] = g
    if n_max > 1:
        out[1] = np.sqrt(2.0) * x * g
    for n in range(2, n_max):
        out[n] = (np.sqrt(2.0 / n) * x * out[n - 1]
                  - np.sqrt((n - 1.0) / n) * out[n - 2])
    return out


def merge_weights(sampling: np.ndarray = SAMPLING
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """BP/RP linear crossfade weights on the output grid."""
    s = np.asarray(sampling, np.float64)
    ramp = np.clip((s - RP_WL_LOW) / (BP_WL_HIGH - RP_WL_LOW), 0.0, 1.0)
    return 1.0 - ramp, ramp


# ---------------------------------------------------------------------------
# design-matrix construction (the bake)
# ---------------------------------------------------------------------------


def _spline_eval(x_knots, y_knots, x):
    """Cubic interpolating spline evaluation (GaiaXPy uses scipy splrep
    s=0); falls back to linear interp without scipy."""
    try:
        from scipy import interpolate

        tck = interpolate.splrep(x_knots, y_knots, s=0)
        return interpolate.splev(x, tck, der=0)
    except ImportError:  # pragma: no cover
        return np.interp(x, x_knots, y_knots)


def build_design_matrix(sampling: np.ndarray, bases: Dict,
                        disp_wl: np.ndarray, disp_pwl: np.ndarray,
                        resp_wl: np.ndarray, resp_r: np.ndarray,
                        weights: np.ndarray) -> np.ndarray:
    """Per-band design matrix (nBases, len(sampling)) in W·nm⁻¹·m⁻² per
    unit coefficient: Hermite bases on the dispersion-rescaled grid,
    projected through inverseBases/transformation, normalized by the
    instrument response (photon→energy conversion HC_NM/(A·r·λ))."""
    sampling = np.asarray(sampling, np.float64)
    weights = np.asarray(weights, np.float64)

    scale = ((bases["normRangeMax"] - bases["normRangeMin"])
             / (bases["pwlRangeMax"] - bases["pwlRangeMin"]))
    offset = bases["normRangeMin"] - bases["pwlRangeMin"] * scale

    pwl = _spline_eval(disp_wl, disp_pwl, sampling)
    rescaled = pwl * scale + offset

    h = hermite_functions(bases["inverseBases"].shape[1], rescaled)
    h = h * (weights > 0)
    design = bases["transformation"] @ (bases["inverseBases"] @ h)

    r = _spline_eval(resp_wl, resp_r, sampling)
    norm = np.where(r > 0, HC_NM / (TELESCOPE_PUPIL_AREA
                                    * np.where(r > 0, r, 1.0) * sampling), 0.0)
    return np.nan_to_num(design * norm)


def _parse_paren_array(s: str) -> np.ndarray:
    s = s.strip()
    if s.startswith("(") and s.endswith(")"):
        s = s[1:-1]
    return np.fromstring(s.strip().rstrip(","), sep=",", dtype=np.float64)


def load_gaiaxpy_bases_csv(path: str) -> Dict:
    """Parse a GaiaXPy bases CSV (single row, parenthesised arrays)."""
    import csv

    with open(path, newline="") as f:
        rows = list(csv.DictReader(f))
    row = rows[0]
    n_bases = int(row["nBases"])
    n_inv = int(row["nInverseBasesCoefficients"])
    n_tr = int(row["nTransformedBases"])
    return {
        "pwlRangeMin": float(row["pwlRangeMin"]),
        "pwlRangeMax": float(row["pwlRangeMax"]),
        "normRangeMin": float(row["normRangeMin"]),
        "normRangeMax": float(row["normRangeMax"]),
        "inverseBases": _parse_paren_array(
            row["inverseBasesCoefficients"]).reshape(n_bases, n_inv),
        "transformation": _parse_paren_array(
            row["transformationMatrix"]).reshape(n_bases, n_tr),
    }


def bake_design(config_dir: str,
                out_path: Optional[str] = None) -> Dict[str, np.ndarray]:
    """Build both bands' design matrices from a GaiaXPy config directory
    (bpC03_v375wi_* / rpC03_v142r_* CSVs) and optionally save as .npz."""
    def two_col(path):
        arr = np.genfromtxt(path, delimiter=",")
        return arr[0], arr[1]

    bp_w, rp_w = merge_weights(SAMPLING)
    out = {}
    for band, tag, w in (("bp", "bpC03_v375wi", bp_w),
                         ("rp", "rpC03_v142r", rp_w)):
        bases = load_gaiaxpy_bases_csv(
            os.path.join(config_dir, f"{tag}_bases.csv"))
        disp = two_col(os.path.join(config_dir, f"{tag}_dispersion.csv"))
        resp = two_col(os.path.join(config_dir, f"{tag}_response.csv"))
        out[f"{band}_design"] = build_design_matrix(
            SAMPLING, bases, *disp, *resp, w)
    out["bp_merge"] = bp_w
    out["rp_merge"] = rp_w
    if out_path:
        np.savez_compressed(out_path, **out)
    return out


def parse_design_c(path: str) -> Dict[str, np.ndarray]:
    """Ingest a reference-format ``gaia_xp_design.c`` at runtime (users
    with a Siril source tree can reuse its baked matrices directly)."""
    with open(path) as f:
        text = f.read()
    out = {}
    for cname, key in (("gaia_xp_bp_design", "bp_design"),
                       ("gaia_xp_rp_design", "rp_design"),
                       ("gaia_xp_bp_merge", "bp_merge"),
                       ("gaia_xp_rp_merge", "rp_merge")):
        m = re.search(r"const double %s\[\d+\] = \{(.*?)\};" % cname,
                      text, re.S)
        if not m:
            raise ValueError(f"array {cname} not found in {path}")
        body = m.group(1).replace("\n", " ").strip().rstrip(",")
        out[key] = np.fromstring(body, sep=",")
    for k in ("bp_design", "rp_design"):
        out[k] = out[k].reshape(-1, XPSAMPLED_LEN)
    return out


_DESIGN_CACHE: Optional[Dict[str, np.ndarray]] = None


def load_design(path: Optional[str] = None) -> Optional[Dict[str, np.ndarray]]:
    """Resolve the XP design matrices: explicit path → $SIRIL_TPU_XP_DESIGN
    → None.  Accepts .npz artifacts, gaia_xp_design.c files, or GaiaXPy
    config directories."""
    global _DESIGN_CACHE
    if path is None and _DESIGN_CACHE is not None:
        return _DESIGN_CACHE
    p = path or os.environ.get("SIRIL_TPU_XP_DESIGN")
    if not p or not os.path.exists(p):
        return None
    if os.path.isdir(p):
        d = bake_design(p)
    elif p.endswith(".c"):
        d = parse_design_c(p)
    else:
        with np.load(p) as z:
            d = {k: z[k] for k in z.files}
    if path is None:
        _DESIGN_CACHE = d
    return d


# ---------------------------------------------------------------------------
# runtime: continuous coefficients → sampled spectrum (batched GEMV)
# ---------------------------------------------------------------------------


def xpcts_to_xpsampled(bp_coeffs: np.ndarray, rp_coeffs: np.ndarray,
                       design: Dict[str, np.ndarray],
                       truncation: int = 0,
                       bp_n_relevant: Optional[np.ndarray] = None,
                       rp_n_relevant: Optional[np.ndarray] = None
                       ) -> np.ndarray:
    """Batched equivalent of ``xpcts_to_xpsampled`` (xp_continuous.cpp:15):
    (S, nbases) float32 coefficients → (S, 343) float64 sampled flux.

    ``truncation``: 0 → all bases; XPCTS_USE_HINT → per-source hints;
    1..nbases → force N for both bands.
    """
    bp = np.atleast_2d(np.asarray(bp_coeffs, np.float64))
    rp = np.atleast_2d(np.asarray(rp_coeffs, np.float64))
    bp_d = np.asarray(design["bp_design"], np.float64)
    rp_d = np.asarray(design["rp_design"], np.float64)
    nb = bp_d.shape[0]

    def fit_cols(a):
        if a.shape[1] >= nb:
            return a[:, :nb]
        out = np.zeros((a.shape[0], nb), a.dtype)
        out[:, :a.shape[1]] = a
        return out

    bp = fit_cols(bp)
    rp = fit_cols(rp)

    def trunc_mask(hints, coeffs):
        if truncation == XPCTS_USE_HINT and hints is not None:
            nrel = np.where(np.asarray(hints) > 0, np.asarray(hints), nb)
            return (np.arange(coeffs.shape[1])[None, :]
                    < np.minimum(nrel, nb)[:, None])
        if truncation > 0:
            return (np.arange(coeffs.shape[1])[None, :]
                    < min(truncation, nb))
        return None

    mbp = trunc_mask(bp_n_relevant, bp)
    mrp = trunc_mask(rp_n_relevant, rp)
    if mbp is not None:
        bp = np.where(mbp, bp, 0.0)
    if mrp is not None:
        rp = np.where(mrp, rp, 0.0)

    flux = (bp @ bp_d) * design["bp_merge"][None, :] \
        + (rp @ rp_d) * design["rp_merge"][None, :]
    return flux


def flux_to_relcount(flux: np.ndarray,
                     sampling: np.ndarray = SAMPLING) -> np.ndarray:
    """W·m⁻²·nm⁻¹ → relative photon count normalized at sample index 82
    (spcc.c:99 flux_to_relcount — its comment says 550 nm but index 82 of
    the 336..1020 step-2 grid is 500 nm; we replicate the code)."""
    y = np.atleast_2d(flux) * sampling[None, :]
    norm = y[:, 82:83]
    norm = np.where(norm != 0.0, norm, 1.0)
    return y / norm


# ---------------------------------------------------------------------------
# synthetic instrument model (tests / demos)
# ---------------------------------------------------------------------------


def synthetic_instrument_model(band: str, n_bases: int = 12,
                               n_inv: int = 16):
    """A small fake instrument: linear dispersion over the band's range,
    smooth Gaussian-ish response, random orthogonal-ish projection
    matrices.  Deterministic per band."""
    rng = np.random.default_rng(17 if band == "bp" else 42)
    if band == "bp":
        wl_lo, wl_hi = 330.0, 650.0
    else:
        wl_lo, wl_hi = 630.0, 1022.0
    disp_wl = np.linspace(wl_lo, wl_hi, 40)
    disp_pwl = np.linspace(0.0, 60.0, 40) + 0.5 * np.sin(disp_wl / 37.0)
    resp_wl = np.linspace(wl_lo, wl_hi, 60)
    mid = 0.5 * (wl_lo + wl_hi)
    resp_r = np.exp(-0.5 * ((resp_wl - mid) / (0.25 * (wl_hi - wl_lo))) ** 2)
    inv = rng.standard_normal((n_bases, n_inv)) / np.sqrt(n_inv)
    tr = np.eye(n_bases) + 0.05 * rng.standard_normal((n_bases, n_bases))
    bases = {
        "pwlRangeMin": 0.0, "pwlRangeMax": 60.0,
        "normRangeMin": -4.0, "normRangeMax": 4.0,
        "inverseBases": inv, "transformation": tr,
    }
    return bases, (disp_wl, disp_pwl), (resp_wl, resp_r)


def synthetic_design(n_bases: int = 12) -> Dict[str, np.ndarray]:
    """Full synthetic bake: the offline test stand-in for the real
    GaiaXPy-derived matrices (same shapes, same pipeline)."""
    bp_w, rp_w = merge_weights(SAMPLING)
    out = {"bp_merge": bp_w, "rp_merge": rp_w}
    for band, w in (("bp", bp_w), ("rp", rp_w)):
        bases, disp, resp = synthetic_instrument_model(band, n_bases)
        d = build_design_matrix(SAMPLING, bases, *disp, *resp, w)
        pad = np.zeros((XPCTS_NBASES, XPSAMPLED_LEN))
        pad[:n_bases] = d
        out[f"{band}_design"] = pad
    return out
