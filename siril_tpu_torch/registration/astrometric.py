"""Astrometric registration — counterpart of
``siril_tpu/registration/astrometric.py`` (``_frame_wcs``:23,
``fit_homography_from_wcs``:41, ``register_astrometric``:76), the
reference's ``src/registration/astrometric.c``
(compute_Hs_from_astrometry:239): the homographies of a mosaic from each
frame's plate solution.  After ``seqplatesolve`` every frame carries a
WCS; frame pixels → sky (the frame's WCS) → reference pixels (the
reference's WCS), fitted as one 3×3 homography per frame by a DLT least
squares over a grid of pixels.  Host numpy: the warp that follows
(``seqapplyreg``) is the device's work.
"""

from __future__ import annotations

import logging
from typing import List, Optional

import numpy as np

from siril_tpu_torch.core.sequence import SEQ_REGULAR, Sequence

_log = logging.getLogger(__name__)


def _frame_wcs(seq: Sequence, index: int):
    """One frame's WCS: a header read for FITS files, the frame itself for
    SER videos, FITS cubes and films."""
    from siril_tpu_torch.ops.wcs import WCS

    if seq.seq_type == SEQ_REGULAR:
        from siril_tpu_torch.io.fits_io import scan_hdus

        path = seq.frame_path(index)
        if path is None:
            return None
        hdus = [h for h in scan_hdus(path) if len(h.naxes) >= 2]
        if not hdus:
            return None
        return WCS.from_header(hdus[0].header)
    return seq.read_frame(index).wcs


def fit_homography_from_wcs(wcs_i, wcs_ref, width: int, height: int,
                            grid: int = 8) -> Optional[np.ndarray]:
    """DLT least-squares homography H (frame i → reference) sampled on a
    pixel grid projected through both WCS solutions."""
    xs = np.linspace(0, width - 1, grid)
    ys = np.linspace(0, height - 1, grid)
    gx, gy = np.meshgrid(xs, ys)
    ra, dec = wcs_i.pix2world(gx.ravel(), gy.ravel())
    rx, ry = wcs_ref.world2pix(ra, dec)
    if not (np.all(np.isfinite(rx)) and np.all(np.isfinite(ry))):
        return None
    # two rows of the 8-unknown system (h33 = 1) for each point
    x, y = gx.ravel(), gy.ravel()
    n = x.size
    A = np.zeros((2 * n, 8))
    b = np.zeros(2 * n)
    A[0::2, 0] = x
    A[0::2, 1] = y
    A[0::2, 2] = 1
    A[0::2, 6] = -x * rx
    A[0::2, 7] = -y * rx
    b[0::2] = rx
    A[1::2, 3] = x
    A[1::2, 4] = y
    A[1::2, 5] = 1
    A[1::2, 6] = -x * ry
    A[1::2, 7] = -y * ry
    b[1::2] = ry
    sol, *_ = np.linalg.lstsq(A, b, rcond=None)
    return np.array([[sol[0], sol[1], sol[2]],
                     [sol[3], sol[4], sol[5]],
                     [sol[6], sol[7], 1.0]])


def register_astrometric(seq: Sequence, layer: int = 0,
                         grid: int = 8) -> int:
    """Fill the sequence's registration data from the frames' plate
    solutions (compute_Hs_from_astrometry) and return the number of
    frames registered.  The reference frame is the sequence's if it is
    solved, else the first solved frame; a frame whose mapping is
    degenerate is unselected."""
    n = seq.number
    wcss: List = [None] * n
    solved = []
    for i in range(n):
        if not seq.incl[i]:
            continue
        w = _frame_wcs(seq, i)
        wcss[i] = w
        if w is not None:
            solved.append(i)
    if len(solved) < 2:
        _log.warning("astrometric registration needs ≥2 plate-solved "
                     "frames (run seqplatesolve first)")
        return 0
    ref = seq.get_reference()
    if ref not in solved:
        ref = solved[0]
        seq.reference_image = ref
    reg = seq.reg(layer)
    count = 0
    for i in solved:
        if seq.is_variable and seq.imgsize is not None:
            w_i, h_i = int(seq.imgsize[i][0]), int(seq.imgsize[i][1])
        else:
            w_i, h_i = seq.rx, seq.ry
        H = (np.eye(3) if i == ref else
             fit_homography_from_wcs(wcss[i], wcss[ref], w_i, h_i, grid))
        if H is None:
            _log.warning("frame %d: degenerate WCS mapping, skipped", i + 1)
            seq.incl[i] = False
            continue
        reg.H[i] = H
        reg.valid[i] = True
        count += 1
    _log.info("Astrometric registration: %d frames aligned from their WCS "
              "solutions (reference: %d)", count, ref + 1)
    return count
