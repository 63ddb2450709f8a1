"""1/2/3-star registration — counterpart of
``siril_tpu/registration/threestars.py`` (``_fit_star_near``:25,
``register_three_stars``:66), the headless form of the reference's
GUI-picked method (``src/registration/3stars.c``): up to three stars
picked on the reference frame are followed on every frame, and a shift
(one star) or a similarity (two or three) is stored in the registration
data.  A frame where a star is lost is unselected, as the reference's
follow does.

CLI: ``register seq -3stars -star1=x,y [-star2=x,y] [-star3=x,y]
[-boxsize=n]``.  The follow is a host search of a small box per star
(median background, brightest peak, a flux-weighted 7×7 centroid), so it
reads each frame and computes nothing on the device.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import List, Optional, Sequence as Seq, Tuple

import numpy as np

from siril_tpu_torch.core.sequence import Sequence
from siril_tpu_torch.registration.matching import (
    SHIFT_TRANSFORMATION,
    SIMILARITY_TRANSFORMATION,
    estimate_transform,
)

_log = logging.getLogger(__name__)


def _fit_star_near(layer: np.ndarray, x0: float, y0: float,
                   box: int) -> Optional[Tuple[float, float]]:
    """The centroid of the brightest peak in a box around (x0, y0), or
    None when no credible star is there."""
    h, w = layer.shape
    half = box // 2
    xi, yi = int(round(x0)), int(round(y0))
    if not (half <= xi < w - half and half <= yi < h - half):
        return None
    win = layer[yi - half:yi + half + 1, xi - half:xi + half + 1]
    bg = float(np.median(win))
    peak = win.max()
    if peak - bg < 3.0 * (np.median(np.abs(win - bg)) * 1.4826 + 1e-6):
        return None
    py, px = np.unravel_index(int(win.argmax()), win.shape)
    # a peak on the box's border is a star that drifted out
    if (py < 2 or px < 2 or py > win.shape[0] - 3 or px > win.shape[1] - 3):
        return None
    # sub-pixel: flux-weighted centroid of the background-subtracted 7×7
    # core around the peak (PSF.c's minimisation seed)
    r = 3
    y1 = max(py - r, 0)
    y2 = min(py + r + 1, win.shape[0])
    x1 = max(px - r, 0)
    x2 = min(px + r + 1, win.shape[1])
    core = np.maximum(win[y1:y2, x1:x2] - bg, 0.0)
    tot = core.sum()
    if tot <= 0:
        return None
    yy, xx = np.mgrid[y1:y2, x1:x2]
    cx = float((core * xx).sum() / tot)
    cy = float((core * yy).sum() / tot)
    return (xi - half + cx, yi - half + cy)


@dataclass
class ThreeStarResult:
    registered: int
    failed: List[int]


def register_three_stars(seq: Sequence, stars: Seq[Tuple[float, float]],
                         layer: int = 0, box: int = 30) -> ThreeStarResult:
    """Follow up to three picked stars across the selected frames and
    store shift (one star) or similarity (two, three) matrices in the
    registration data, then save the ``.seq``."""
    if not 1 <= len(stars) <= 3:
        raise ValueError("pick 1 to 3 stars")
    indices = seq.selected_indices()
    ref = seq.get_reference()
    ref_img = seq.read_frame(int(ref)).host()[layer]

    ref_pos = []
    for (x, y) in stars:
        p = _fit_star_near(ref_img, x, y, box)
        if p is None:
            raise ValueError(f"no star found near ({x:.0f},{y:.0f}) on the "
                             "reference frame")
        ref_pos.append(p)
    ref_pos = np.asarray(ref_pos)
    ttype = SHIFT_TRANSFORMATION if len(stars) == 1 \
        else SIMILARITY_TRANSFORMATION

    reg = seq.reg(layer)
    ok = 0
    failed: List[int] = []
    for idx in indices:
        idx = int(idx)
        if idx == ref:
            reg.H[idx] = np.eye(3)
            reg.valid[idx] = True
            ok += 1
            continue
        img = seq.read_frame(idx).host()[layer]
        pos = []
        for (rx, ry) in ref_pos:
            p = _fit_star_near(img, rx, ry, box)
            if p is None:
                break
            pos.append(p)
        if len(pos) < len(ref_pos):
            _log.error("3stars: frame %d: star lost; unselecting", idx + 1)
            seq.incl[idx] = False
            failed.append(idx)
            continue
        reg.H[idx] = estimate_transform(np.asarray(pos), ref_pos, ttype)
        reg.valid[idx] = True
        ok += 1
    _log.info("3-star registration: %d frames registered (%d lost)", ok,
              len(failed))
    seq.save()
    return ThreeStarResult(registered=ok, failed=failed)
