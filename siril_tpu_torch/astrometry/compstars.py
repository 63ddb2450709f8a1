"""Comparison stars — counterpart of ``siril_tpu/astrometry/compstars.py``
(src/algos/comparison_stars.c, findcompstars:519): ``CompStarArgs``,
``find_comp_stars``, ``export_nina_csv`` and ``export_compstars_list``,
host numpy.  Comparison stars are picked near a target by ΔV magnitude and
ΔB−V colour; the selection is exported as a NINA exoplanet CSV and a
Siril comparison-star list.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

_log = logging.getLogger(__name__)


@dataclass
class CompStarArgs:
    delta_vmag: float = 3.0       # max |V - V_target|
    delta_bv: float = 0.5         # max |BV - BV_target|
    max_emag: float = 0.03        # max catalogue mag error
    narrow_fov: bool = True       # keep stars in the inner 90% of field


def find_comp_stars(img, catalog, target_xy: Tuple[float, float],
                    args: Optional[CompStarArgs] = None):
    """Returns (target_entry, [comparison entries]) with pixel positions."""
    args = args or CompStarArgs()
    w = img.wcs
    if w is None:
        raise ValueError("findcompstars requires a plate-solved image")
    H, W = img.height, img.width
    fov = w.pixel_scale_arcsec * max(H, W) / 3600.0
    ra_c, dec_c = w.pix2world(np.array([W / 2.0]), np.array([H / 2.0]))
    cone = catalog.cone_search(float(ra_c[0]), float(dec_c[0]), fov, 99.0)
    if len(cone) == 0:
        raise ValueError("no catalogue stars in field")
    x, y = w.world2pix(cone.ra, cone.dec)
    # identify the target = nearest catalogue star to the clicked pixel
    d2 = (x - target_xy[0]) ** 2 + (y - target_xy[1]) ** 2
    ti = int(np.argmin(d2))
    if d2[ti] > 15 ** 2:
        raise ValueError("no catalogue star near the target position")
    tmag = float(cone.mag[ti])
    tbv = float(cone.bv[ti]) if cone.bv is not None else 0.65
    margin = 0.05 * min(H, W) if args.narrow_fov else 0.0
    comps = []
    for k in range(len(cone)):
        if k == ti:
            continue
        if not (margin <= x[k] < W - margin and margin <= y[k] < H - margin):
            continue
        if abs(float(cone.mag[k]) - tmag) > args.delta_vmag:
            continue
        bv = float(cone.bv[k]) if cone.bv is not None else 0.65
        if abs(bv - tbv) > args.delta_bv:
            continue
        comps.append({"ra": float(cone.ra[k]), "dec": float(cone.dec[k]),
                      "mag": float(cone.mag[k]), "bv": bv,
                      "x": float(x[k]), "y": float(y[k])})
    comps.sort(key=lambda c: abs(c["mag"] - tmag))
    target = {"ra": float(cone.ra[ti]), "dec": float(cone.dec[ti]),
              "mag": tmag, "bv": tbv, "x": float(x[ti]), "y": float(y[ti])}
    _log.info("findcompstars: %d comparison stars (target V=%.2f)",
              len(comps), tmag)
    return target, comps


def export_nina_csv(target: dict, comps: List[dict], path: str,
                    name: str = "Target") -> None:
    """NINA exoplanet CSV format (comparison_stars.c export)."""
    with open(path, "w") as f:
        f.write("Type,Name,HFR,xPos,yPos,AvgBright,MaxBright,Background,"
                "Ra,Dec\n")
        f.write(f"Target,{name},,," "" f",,,,{target['ra']:.6f},"
                f"{target['dec']:.6f}\n")
        for i, c in enumerate(comps, 1):
            f.write(f"Comparison,C{i},,,,,,,{c['ra']:.6f},{c['dec']:.6f}\n")


def export_compstars_list(target: dict, comps: List[dict], path: str) -> None:
    with open(path, "w") as f:
        f.write("# x y mag bv role\n")
        f.write(f"{target['x']:.2f} {target['y']:.2f} {target['mag']:.3f} "
                f"{target['bv']:.3f} target\n")
        for c in comps:
            f.write(f"{c['x']:.2f} {c['y']:.2f} {c['mag']:.3f} "
                    f"{c['bv']:.3f} comp\n")
