"""Plate solver — counterpart of ``siril_tpu/astrometry/solver.py``
(``SolveArgs``:34, ``scale_from_optics``:57, ``solve_image``:62,
``_try_solve``:129, ``fit_wcs``:197), the reference's
``src/algos/astrometry_solver.c`` (plate_solver:881): star detection →
catalogue cone search → triangle match → linear TAN fit → SIP terms →
WCS.

Detection is the port's ``registration/starfinder.detect_stars`` on the
caller's device; the triangle match and RANSAC are the registration's
(``registration/matching.py``), so the solver needs only an approximate
centre and pixel scale to pick and project the catalogue region, and a
spiral of trial centres (siril_near_platesolve:857) widens the search
when the hints are off.  The fit runs on the host, in float64:
  1. sky → standard coordinates (ξ, η) about the current CRVAL;
  2. linear least squares ξ = a₀ + a₁u + a₂v, η = b₀ + b₁u + b₂v
     (CD = [[a₁, a₂], [b₁, b₂]]; the constant terms move CRVAL);
  3. with ``sip_order`` ≥ 2, a polynomial least-squares fit of the
     residuals in (u, v), FITS bottom-up v, as ``WCS.pix2world`` reads
     them.
"""

from __future__ import annotations

import logging
import math
import time
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from siril_tpu_torch.astrometry.catalog import Catalog
from siril_tpu_torch.core.image import SirilImage
from siril_tpu_torch.device import DeviceLike, resolve_device
from siril_tpu_torch.ops.wcs import (
    WCS,
    _sky_to_tan,
    _tan_to_sky,
    parse_dec,
    parse_ra,
)
from siril_tpu_torch.registration.matching import (
    SIMILARITY_TRANSFORMATION,
    _apply_h,
    match_triangles,
    ransac_transform,
)

_log = logging.getLogger(__name__)


@dataclass
class SolveArgs:
    ra: Optional[float] = None          # hint center (deg)
    dec: Optional[float] = None
    pixel_scale: Optional[float] = None  # arcsec/px hint
    focal_mm: Optional[float] = None
    pixel_size_um: Optional[float] = None
    radius_deg: float = 1.0             # search radius around hint
    mag_limit: float = 14.0
    max_stars: int = 100
    sip_order: int = 0                  # 0 = no SIP


@dataclass
class SolveResult:
    wcs: WCS
    n_matched: int
    residual_arcsec: float
    scale_arcsec: float
    rotation_deg: float


def scale_from_optics(focal_mm: float, pixel_size_um: float) -> float:
    """arcsec/px from focal length + pixel size (the reference's hint)."""
    return 206.265 * pixel_size_um / focal_mm


def solve_image(img: SirilImage, catalog: Catalog,
                args: Optional[SolveArgs] = None,
                device: DeviceLike = None,
                stages: Optional[dict] = None) -> Optional[SolveResult]:
    """Plate-solve ``img`` against ``catalog``: stars detected on
    ``device`` (CUDA unless "cpu"), the match and the fit on the host.
    On success ``img.wcs`` is set; ``stages`` (if given) gains the
    seconds of "detect" and "match" (the cone searches, the triangle
    matches and the fit)."""
    from siril_tpu_torch.device import synchronize
    from siril_tpu_torch.registration.starfinder import (
        StarFinderParams,
        detect_stars,
    )

    dev = resolve_device(device)
    args = args or SolveArgs()
    kw = img.keywords
    if args.pixel_scale is None:
        if args.focal_mm and args.pixel_size_um:
            args.pixel_scale = scale_from_optics(args.focal_mm,
                                                 args.pixel_size_um)
        elif kw.focal_length and kw.pixel_size_x:
            args.pixel_scale = scale_from_optics(kw.focal_length,
                                                 kw.pixel_size_x)
        else:
            raise ValueError("plate solve needs a pixel scale hint "
                             "(focal length + pixel size)")
    if args.ra is None or args.dec is None:
        if img.wcs is not None:
            args.ra, args.dec = img.wcs.crval
        else:
            ra_s = kw.extra.get("OBJCTRA") or kw.extra.get("RA")
            dec_s = kw.extra.get("OBJCTDEC") or kw.extra.get("DEC")
            if ra_s is None or dec_s is None:
                raise ValueError("plate solve needs approximate coordinates")
            args.ra = parse_ra(str(ra_s)) if isinstance(ra_s, str) else float(ra_s)
            args.dec = parse_dec(str(dec_s)) if isinstance(dec_s, str) else float(dec_s)

    layer = 1 if img.nchans == 3 else 0
    t = time.perf_counter()
    stars = detect_stars(torch.from_numpy(img.host()[layer]).to(dev),
                         StarFinderParams(), max_stars=args.max_stars * 4)
    synchronize(dev)
    t_detect = time.perf_counter() - t
    t = time.perf_counter()
    if stages is not None:
        stages["detect"] = stages.get("detect", 0.0) + t_detect
    if len(stars) < 8:
        _log.error("plate solve: only %d stars detected", len(stars))
        return None
    spix = np.array([[s.x0, s.y0] for s in stars[:args.max_stars]])

    H, W = img.height, img.width
    fov_deg = args.pixel_scale * max(H, W) / 3600.0
    search_r = max(args.radius_deg, fov_deg)

    # spiral near-solve: try the hint, then a ring of offsets
    offsets = [(0.0, 0.0)]
    step = fov_deg * 0.8
    for ring in (1, 2):
        for a in range(8 * ring):
            th = 2 * math.pi * a / (8 * ring)
            offsets.append((ring * step * math.cos(th),
                            ring * step * math.sin(th)))
    for (dra, ddec) in offsets:
        ra_c = args.ra + dra / max(math.cos(args.dec * math.pi / 180), 1e-6)
        dec_c = args.dec + ddec
        result = _try_solve(spix, catalog, ra_c, dec_c, args.pixel_scale,
                            search_r, args.mag_limit, (H, W),
                            args.max_stars, args.sip_order)
        if result is not None:
            break
    if stages is not None:
        stages["match"] = stages.get("match", 0.0) + time.perf_counter() - t
    if result is None:
        _log.error("plate solve failed (no triangle match)")
        return None
    _log.info("Plate solve: %d stars, scale %.3f\"/px, rotation %+.2f°, "
              "residual %.2f\"", result.n_matched, result.scale_arcsec,
              result.rotation_deg, result.residual_arcsec)
    img.wcs = result.wcs
    return result


def _try_solve(spix, catalog, ra_c, dec_c, scale, radius, mag_limit,
               shape, max_stars, sip_order):
    H, W = shape
    cone = catalog.cone_search(ra_c, dec_c, radius, mag_limit)
    if len(cone) < 8:
        return None
    # project with a trial WCS about the hint, keep only stars that land
    # in (or near) the frame, then the brightest of those
    trial = WCS(crpix=(W / 2.0, H / 2.0), crval=(ra_c, dec_c),
                cd=np.array([[-scale / 3600.0, 0.0], [0.0, scale / 3600.0]]),
                height=H)
    proj = cone.project(trial)
    margin = 0.2 * max(H, W)
    inframe = ((proj[:, 0] > -margin) & (proj[:, 0] < W + margin) &
               (proj[:, 1] > -margin) & (proj[:, 1] < H + margin))
    if inframe.sum() < 8:
        return None
    keep = np.nonzero(inframe)[0]
    order = keep[np.argsort(cone.mag[keep])][:max_stars]
    cone = Catalog(ra=cone.ra[order], dec=cone.dec[order],
                   mag=cone.mag[order], cat_name=cone.cat_name)
    cpix = proj[order]
    pairs = match_triangles(cpix, spix, max_stars=min(len(cone), 25),
                            tol=0.01)
    if len(pairs) < 4:
        # try mirrored (flipped) projection
        trial.cd = np.array([[scale / 3600.0, 0.0], [0.0, scale / 3600.0]])
        cpix = cone.project(trial)
        pairs = match_triangles(cpix, spix, max_stars=min(len(cone), 25),
                                tol=0.01)
        if len(pairs) < 4:
            return None
    cidx = np.array([u for u, _ in pairs])
    sidx = np.array([v for _, v in pairs])
    # robust similarity from star pix → catalog trial pix to filter pairs
    m = ransac_transform(spix[sidx], cpix[cidx], SIMILARITY_TRANSFORMATION,
                         thresh_px=5.0)
    if m is None or m.inliers < 4:
        return None
    # grow matches: project all catalog stars through trial+similarity⁻¹
    # (cheap): accept star/catalog pairs within 4 px
    all_proj = _apply_h(np.linalg.inv(m.H), cpix)   # catalog → star frame
    d2 = ((spix[:, None, :] - all_proj[None, :, :]) ** 2).sum(-1)
    si, ci = np.nonzero(d2 < 16.0)
    # unique greedy
    used_s, used_c, ms, mc = set(), set(), [], []
    for o in np.argsort(d2[si, ci]):
        if si[o] in used_s or ci[o] in used_c:
            continue
        used_s.add(si[o])
        used_c.add(ci[o])
        ms.append(si[o])
        mc.append(ci[o])
    if len(ms) < 6:
        return None
    xpix = spix[ms]
    sky = np.stack([cone.ra[mc], cone.dec[mc]], axis=1)
    wcs, resid = fit_wcs(xpix, sky, (H, W), sip_order)
    if wcs is None or resid > 5.0 * scale:
        return None
    return SolveResult(wcs=wcs, n_matched=len(ms),
                       residual_arcsec=resid,
                       scale_arcsec=wcs.pixel_scale_arcsec,
                       rotation_deg=wcs.rotation_deg)


def fit_wcs(pix: np.ndarray, sky: np.ndarray, shape, sip_order: int = 0,
            iters: int = 3):
    """Fit a TAN(-SIP) WCS from (N,2) pixel ↔ (N,2) RA/Dec pairs."""
    H, W = shape
    crpix = (W / 2.0 + 0.5, H / 2.0 + 0.5)      # 1-based center
    crval = (float(np.mean(sky[:, 0])), float(np.mean(sky[:, 1])))
    u = pix[:, 0] + 1.0 - crpix[0]
    v = ((H - 1) - pix[:, 1]) + 1.0 - crpix[1]   # bottom-up FITS v
    cd = None
    for _ in range(iters):
        xi, eta = _sky_to_tan(sky[:, 0], sky[:, 1], crval)
        A = np.stack([np.ones_like(u), u, v], axis=1)
        ax, *_ = np.linalg.lstsq(A, xi, rcond=None)
        ay, *_ = np.linalg.lstsq(A, eta, rcond=None)
        cd = np.array([[ax[1], ax[2]], [ay[1], ay[2]]])
        # fold the constant terms into CRVAL
        ra_new, dec_new = _tan_to_sky(ax[0], ay[0], crval)
        crval = (float(ra_new), float(dec_new))
    wcs = WCS(crpix=crpix, crval=crval, cd=cd, height=H)
    if sip_order >= 2:
        # residuals in intermediate pixel coords
        xi, eta = _sky_to_tan(sky[:, 0], sky[:, 1], crval)
        inv = np.linalg.inv(cd)
        ut = inv[0, 0] * xi + inv[0, 1] * eta
        vt = inv[1, 0] * xi + inv[1, 1] * eta
        du = ut - u
        dv = vt - v
        terms = []
        for i in range(sip_order + 1):
            for j in range(sip_order + 1 - i):
                if i + j >= 2:
                    terms.append((i, j))
        G = np.stack([(u ** i) * (v ** j) for i, j in terms], axis=1)
        ca, *_ = np.linalg.lstsq(G, du, rcond=None)
        cb, *_ = np.linalg.lstsq(G, dv, rcond=None)
        A_m = np.zeros((sip_order + 1, sip_order + 1))
        B_m = np.zeros((sip_order + 1, sip_order + 1))
        for k, (i, j) in enumerate(terms):
            A_m[i, j] = ca[k]
            B_m[i, j] = cb[k]
        wcs.sip_a = A_m
        wcs.sip_b = B_m
    # residual
    x2, y2 = wcs.world2pix(sky[:, 0], sky[:, 1])
    resid_px = float(np.hypot(x2 - pix[:, 0], y2 - pix[:, 1]).mean())
    return wcs, resid_px * wcs.pixel_scale_arcsec
