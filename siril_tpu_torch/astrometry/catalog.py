"""Star catalogues — counterpart of ``siril_tpu/astrometry/catalog.py``
(``Catalog``:29 with ``load``:45, ``save``:58, ``cone_search``:67,
``brightest``:88, ``project``:95; ``default_catalog_path``:111), the
reference's unified catalogue object (``src/io/siril_catalogues.c``) and
the cone search of its local catalogues.  Host numpy.

A plain local catalogue is an ``.npz`` / ``.sscat`` file with the arrays
ra (deg), dec (deg), mag and optionally bv, sorted by dec, or a CSV with
the columns ra,dec,mag and optionally bv.  The reference's binary catalogues are
``gaia_local.py`` (HEALPix) and ``kstars_local.py`` (HTM).
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass
from typing import List, Optional

import numpy as np

D2R = math.pi / 180.0


@dataclass
class Catalog:
    ra: np.ndarray
    dec: np.ndarray
    mag: np.ndarray
    bv: Optional[np.ndarray] = None           # B−V color (PCC/SPCC)
    pmra: Optional[np.ndarray] = None         # proper motion (mas/yr)
    pmdec: Optional[np.ndarray] = None
    names: Optional[List[str]] = None
    xp_sampled: Optional[np.ndarray] = None   # (N, 343) Gaia XP spectra
    cat_name: str = "local"

    def __len__(self):
        return len(self.ra)

    # ------------------------------------------------------------------
    @staticmethod
    def load(path: str) -> "Catalog":
        if path.endswith(".npz") or path.endswith(".sscat"):
            z = np.load(path, allow_pickle=False)
            return Catalog(ra=z["ra"], dec=z["dec"], mag=z["mag"],
                           bv=z["bv"] if "bv" in z else None,
                           cat_name=os.path.basename(path))
        # CSV; a bv column is kept (the JAX package drops it, so that its
        # pcc refuses a CSV catalogue: ROADMAP §3)
        rows = np.genfromtxt(path, delimiter=",", names=True)
        return Catalog(ra=np.atleast_1d(rows["ra"]),
                       dec=np.atleast_1d(rows["dec"]),
                       mag=np.atleast_1d(rows["mag"]),
                       bv=np.atleast_1d(rows["bv"])
                       if "bv" in rows.dtype.names else None,
                       cat_name=os.path.basename(path))

    def save(self, path: str) -> None:
        order = np.argsort(self.dec)
        extra = {}
        if self.bv is not None:
            extra["bv"] = self.bv[order]
        np.savez_compressed(path, ra=self.ra[order], dec=self.dec[order],
                            mag=self.mag[order], **extra)

    # ------------------------------------------------------------------
    def cone_search(self, ra0: float, dec0: float, radius_deg: float,
                    mag_limit: float = 99.0) -> "Catalog":
        """Cone search (siril_catalog_get_stars_from_local_catalogues)."""
        # cheap box prefilter then exact angular distance
        dmask = np.abs(self.dec - dec0) <= radius_deg
        cosd = max(math.cos(dec0 * D2R), 1e-6)
        dra = np.abs(((self.ra - ra0 + 180.0) % 360.0) - 180.0)
        rmask = dra <= radius_deg / cosd
        m = dmask & rmask & (self.mag <= mag_limit)
        idx = np.nonzero(m)[0]
        if len(idx):
            d = _ang_dist(self.ra[idx], self.dec[idx], ra0, dec0)
            idx = idx[d <= radius_deg]
        return Catalog(ra=self.ra[idx], dec=self.dec[idx],
                       mag=self.mag[idx],
                       bv=self.bv[idx] if self.bv is not None else None,
                       pmra=self.pmra[idx] if self.pmra is not None else None,
                       pmdec=self.pmdec[idx] if self.pmdec is not None else None,
                       names=[self.names[i] for i in idx] if self.names else None,
                       cat_name=self.cat_name)

    def brightest(self, n: int) -> "Catalog":
        order = np.argsort(self.mag)[:n]
        return Catalog(ra=self.ra[order], dec=self.dec[order],
                       mag=self.mag[order],
                       bv=self.bv[order] if self.bv is not None else None,
                       cat_name=self.cat_name)

    def project(self, wcs) -> np.ndarray:
        """(N,2) pixel positions under a WCS (catalogue→image plane)."""
        x, y = wcs.world2pix(self.ra, self.dec)
        return np.stack([x, y], axis=1)


def _ang_dist(ra, dec, ra0, dec0):
    ra = np.asarray(ra) * D2R
    dec = np.asarray(dec) * D2R
    r0 = ra0 * D2R
    d0 = dec0 * D2R
    cosd = (np.sin(dec) * np.sin(d0) +
            np.cos(dec) * np.cos(d0) * np.cos(ra - r0))
    return np.degrees(np.arccos(np.clip(cosd, -1.0, 1.0)))


def default_catalog_path() -> Optional[str]:
    """Installed local catalogue location (the reference downloads its
    catalogues to a data dir; same idea)."""
    for base in (os.environ.get("SIRIL_TPU_CATALOG"),
                 os.path.expanduser("~/.local/share/siril_tpu/catalog.sscat"),
                 os.path.expanduser("~/.local/share/siril_tpu/catalog.npz")):
        if base and os.path.exists(base):
            return base
    return None
