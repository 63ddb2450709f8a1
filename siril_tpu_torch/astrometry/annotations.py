"""Annotation catalogues and the by-name object search — counterpart of
``siril_tpu/astrometry/annotations.py`` (``load_catalogues``:58,
``find_object``:76, ``annotate_image``:85), the reference's
``src/io/annotation_catalogues.c`` (``show``) and the local part of
``src/algos/search_objects.c`` (``catsearch``).

A compact built-in list of bright Messier / NGC / IC objects, extended by
the user's CSV catalogues (``~/.local/share/siril_tpu/annotations/*.csv``,
columns name,ra,dec).  Host code.
"""

from __future__ import annotations

import csv
import os
from dataclasses import dataclass
from typing import List, Optional

import numpy as np

# compact built-in catalogue (name, RA deg, Dec deg) — bright Messier
# objects for annotation smoke coverage; user CSVs extend this
_BUILTIN = [
    ("M1", 83.633, 22.0145), ("M8", 270.904, -24.387),
    ("M13", 250.4235, 36.4613), ("M16", 274.7, -13.807),
    ("M20", 270.675, -23.027), ("M27", 299.901, 22.721),
    ("M31", 10.6847, 41.269), ("M33", 23.462, 30.660),
    ("M42", 83.8221, -5.3911), ("M45", 56.75, 24.1167),
    ("M51", 202.4696, 47.1952), ("M57", 283.396, 33.029),
    ("M63", 198.9554, 42.0293), ("M64", 194.1821, 21.6827),
    ("M65", 169.733, 13.0923), ("M66", 170.0625, 12.9915),
    ("M74", 24.174, 15.7836), ("M81", 148.8882, 69.0653),
    ("M82", 148.9685, 69.6797), ("M83", 204.2538, -29.8657),
    ("M94", 192.7213, 41.1204), ("M97", 168.6988, 55.0190),
    ("M101", 210.8024, 54.3488), ("M104", 189.9976, -11.623),
    ("M106", 184.7401, 47.3037), ("NGC253", 11.888, -25.2883),
    ("NGC891", 35.6392, 42.3491), ("NGC2237", 97.9875, 4.946),
    ("NGC6960", 311.01, 30.71), ("NGC7000", 312.75, 44.37),
    ("NGC7293", 337.4108, -20.8372), ("IC434", 85.2458, -2.458),
    ("IC1396", 324.75, 57.5),
]


@dataclass
class Annotation:
    name: str
    ra: float
    dec: float
    x: float = 0.0
    y: float = 0.0


def user_catalog_dir() -> str:
    return os.path.expanduser("~/.local/share/siril_tpu/annotations")


def load_catalogues(extra_dir: Optional[str] = None) -> List[Annotation]:
    out = [Annotation(n, r, d) for n, r, d in _BUILTIN]
    for d in (user_catalog_dir(), extra_dir):
        if d and os.path.isdir(d):
            for f in os.listdir(d):
                if not f.endswith(".csv"):
                    continue
                try:
                    with open(os.path.join(d, f)) as fh:
                        for row in csv.DictReader(fh):
                            out.append(Annotation(
                                row.get("name", "?"),
                                float(row["ra"]), float(row["dec"])))
                except (KeyError, ValueError, OSError):
                    pass
    return out


def find_object(name: str) -> Optional[Annotation]:
    """search_objects by-name lookup against local catalogues."""
    key = name.replace(" ", "").upper()
    for a in load_catalogues():
        if a.name.replace(" ", "").upper() == key:
            return a
    return None


def annotate_image(img, mag_limit: float = 99.0) -> List[Annotation]:
    """Objects from the annotation catalogues that land in the solved
    image (`show` command core)."""
    w = img.wcs
    if w is None:
        raise ValueError("annotations require a plate-solved image")
    out = []
    for a in load_catalogues():
        x, y = w.world2pix(np.array([a.ra]), np.array([a.dec]))
        if 0 <= x[0] < img.width and 0 <= y[0] < img.height:
            a.x, a.y = float(x[0]), float(y[0])
            out.append(a)
    return out
