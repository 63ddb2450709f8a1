"""Stacking normalization — counterpart of ``siril_tpu/ops/normalization.py``
(settings.h:34-40 modes, ``NormCoeffs``, ``compute_normalization``:62,
``factors_from_estimators``:121, ``_compute_missing``:151, ``_cache``:199)
and the overlap normalization of mosaics (``compute_overlap``:218,
``_pair_estimators``:245, ``solve_overlap_coeffs``:272,
``compute_overlap_normalization``:303).

Per frame and per layer, location/scale estimators (IKSSlite, or
median/1.5·MAD with ``lite``; normalization.c:98-142) become offset/scale/
mul coefficients relative to the reference frame
(compute_factors_from_estimators, normalization.c:146-183):

  ADDITIVE_SCALING:  scale_i = scale_ref / scale_i ;
                     offset_i = scale_i·loc_i − loc_ref
  ADDITIVE:          offset_i = loc_i − loc_ref          (scale = 1)
  MULTIPLICATIVE[_SCALING]: mul_i = loc_ref / loc_i

Applied per pixel in the stack kernel (median_and_mean.c:1655-1689):
  additive:        v' = v·scale − offset   (zeros stay zero)
  multiplicative:  v' = v·scale·mul

The estimators are ``ops/statistics.norm_estimators`` (sorts on the
device); they are kept in the sequence's in-memory stats store.  The
overlap normalization's pairwise estimators are host numpy medians over
each overlap, as the reference's are (it warns above 30 frames).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from siril_tpu_torch.device import DeviceLike, resolve_device

NO_NORM = 0
ADDITIVE = 1
MULTIPLICATIVE = 2
ADDITIVE_SCALING = 3
MULTIPLICATIVE_SCALING = 4

NORM_NAMES = {
    "no": NO_NORM, "none": NO_NORM,
    "add": ADDITIVE, "additive": ADDITIVE,
    "mul": MULTIPLICATIVE, "multiplicative": MULTIPLICATIVE,
    "addscale": ADDITIVE_SCALING,
    "mulscale": MULTIPLICATIVE_SCALING,
}


@dataclass
class NormCoeffs:
    """(L, N) coefficient arrays (norm_coeff, stacking.h)."""

    offset: np.ndarray
    mul: np.ndarray
    scale: np.ndarray


def has_estimators(st, lite: bool) -> bool:
    """Whether stored stats ``st`` hold the estimators a normalization
    needs."""
    return st is not None and bool(
        (lite and st.median and st.mad) or
        (not lite and st.location and st.scale))


def compute_normalization(seq, indices: np.ndarray, mode: int,
                          lite: bool = False, force: bool = False,
                          frame_batch: int = 8, equalize_rgb: bool = False,
                          reglayer: int = -1, device: DeviceLike = None
                          ) -> NormCoeffs:
    """do_normalization (normalization.c:46-80) for the selected frames
    (absolute ``indices``).  Estimators come from the sequence's stats
    store when present, else are computed on ``device`` (the card unless
    the caller asks for the CPU) in frame batches and stored."""
    device = resolve_device(device)
    n = len(indices)
    L = seq.nb_layers
    if mode == NO_NORM:
        return NormCoeffs(np.zeros((L, n)), np.ones((L, n)), np.ones((L, n)))
    loc = np.zeros((L, n))
    sca = np.ones((L, n))
    need = []
    for k, idx in enumerate(indices):
        for layer in range(L):
            st = None if force else seq.get_frame_stats(layer, int(idx))
            if has_estimators(st, lite):
                loc[layer, k] = st.median if lite else st.location
                sca[layer, k] = 1.5 * st.mad if lite else st.scale
            else:
                need.append((k, int(idx), layer))
    if need:
        _compute_missing(seq, need, loc, sca, lite, frame_batch, device)
    ref_idx = seq.get_reference()
    hit = np.nonzero(np.asarray(indices) == ref_idx)[0]
    ref_pos = int(hit[0]) if hit.size else 0
    offset, scale, mul = factors_from_estimators(
        loc, sca, mode, ref_pos, equalize_rgb=equalize_rgb,
        reglayer=reglayer)
    return NormCoeffs(offset, mul, scale)


def factors_from_estimators(loc: np.ndarray, sca: np.ndarray, mode: int,
                            ref_pos: int, equalize_rgb: bool = False,
                            reglayer: int = -1):
    """compute_factors_from_estimators (normalization.c:146): per-frame
    (offset, scale, mul) from (L, n) location/scale estimator arrays."""
    L, n = loc.shape
    offset = np.zeros((L, n))
    scale = np.ones((L, n))
    mul = np.ones((L, n))
    rl = reglayer if reglayer > -1 else 1
    for layer in range(L):
        reflayer = min(rl if equalize_rgb else layer, L - 1)
        loc0 = loc[reflayer, ref_pos]
        sca0 = sca[reflayer, ref_pos]
        if mode in (ADDITIVE_SCALING, MULTIPLICATIVE_SCALING):
            s = sca[layer]
            scale[layer] = np.where(s == 0, 1.0,
                                    sca0 / np.where(s == 0, 1.0, s))
        if mode in (ADDITIVE, ADDITIVE_SCALING):
            offset[layer] = scale[layer] * loc[layer] - loc0
        elif mode in (MULTIPLICATIVE, MULTIPLICATIVE_SCALING):
            lv = loc[layer]
            mul[layer] = np.where(lv == 0, 1.0,
                                  loc0 / np.where(lv == 0, 1.0, lv))
    return offset, scale, mul


def _compute_missing(seq, need, loc, sca, lite, frame_batch, device):
    """Estimators for (position, frame, layer) triples, frames read from
    disk (4 threads) and batched onto ``device``; results go to
    ``loc``/``sca`` and the stats store."""
    import concurrent.futures as cf

    from siril_tpu_torch.ops.statistics import norm_estimators
    from siril_tpu_torch.utils.devfetch import DeviceCollector

    by_frame = {}
    for k, idx, layer in need:
        by_frame.setdefault((k, idx), []).append(layer)
    items = sorted(by_frame.items())
    col = DeviceCollector()          # one fetch at the end, not one a batch
    meta = []                        # (layer, k, idx) per collected row
    with cf.ThreadPoolExecutor(max_workers=4) as pool:
        for start in range(0, len(items), frame_batch):
            chunk = items[start:start + frame_batch]
            frames = list(pool.map(
                lambda it: seq.read_frame(it[0][1]).host(), chunk))
            for layer in range(seq.nb_layers):
                rows = [ci for ci, (_, layers) in enumerate(chunk)
                        if layer in layers]
                if not rows:
                    continue
                batch = torch.from_numpy(np.stack(
                    [frames[ci][layer].reshape(-1) for ci in rows])
                    ).to(device)
                est = norm_estimators(batch, lite=lite)
                col.append(torch.stack([est["location"], est["scale"],
                                        est["median"], est["mad"]], 1))
                meta += [(layer, *chunk[ci][0]) for ci in rows]
    vals = col.concat()
    for (layer, k, idx), (location, scale_v, med, mad) in zip(meta, vals):
        loc[layer, k] = float(location)
        sca[layer, k] = float(scale_v)
        cache_estimators(seq, layer, idx, float(med), float(mad),
                         float(location), float(scale_v), lite)


def cache_estimators(seq, layer, idx, med, mad, location, scale, lite):
    """Store one frame's estimators in the sequence's stats store."""
    from siril_tpu_torch.ops.statistics import ImStats

    st = seq.get_frame_stats(layer, idx) or ImStats()
    st.median = float(med)
    st.mad = float(mad)
    if not lite:
        st.location = float(location)
        st.scale = float(scale)
    st.total = st.total or seq.rx * seq.ry
    st.ngoodpix = st.ngoodpix or st.total
    seq.set_frame_stats(layer, idx, st)


# ---------------------------------------------------------------------------
# overlap normalization (mosaics) — normalization.c:296-925
# ---------------------------------------------------------------------------


def compute_overlap(seq, layer: int, i: int, j: int):
    """Overlap rectangles ((xi, yi, w, h), (xj, yj, w, h)) of frames i and
    j in each frame's pixels, from their shift-only H and each frame's
    own size (normalization.c:420), or None."""
    H = seq.reg(layer).H
    txi, tyi = round(float(H[i][0, 2])), round(float(H[i][1, 2]))
    txj, tyj = round(float(H[j][0, 2])), round(float(H[j][1, 2]))
    if seq.is_variable and seq.imgsize is not None:
        (rxi, ryi), (rxj, ryj) = seq.imgsize[i], seq.imgsize[j]
    else:
        rxi = rxj = seq.rx
        ryi = ryj = seq.ry
    x0, y0 = max(txi, txj), max(tyi, tyj)
    x1 = min(txi + int(rxi), txj + int(rxj))
    y1 = min(tyi + int(ryi), tyj + int(ryj))
    if x0 >= x1 or y0 >= y1:
        return None
    w, h = x1 - x0, y1 - y0
    return (x0 - txi, y0 - tyi, w, h), (x0 - txj, y0 - tyj, w, h)


def _pair_estimators(di: np.ndarray, dj: np.ndarray, lite: bool):
    """(count, (loc_i, scale_i), (loc_j, scale_j)) over the overlap's
    pixels that are non-zero in both frames (normalization.c:458-600)."""
    from siril_tpu_torch.ops.statistics import ikss_lite_np

    m = (di != 0) & (dj != 0)
    n = int(m.sum())
    if n == 0:
        return 0, (0.0, 1.0), (0.0, 1.0)
    out = []
    for v in (di[m].astype(np.float64), dj[m].astype(np.float64)):
        med = float(np.median(v))
        mad = float(np.median(np.abs(v - med)))
        ls = ikss_lite_np(v, med, mad) if mad > 0 and not lite else None
        if ls is None:
            out.append((med, 1.5 * mad if mad > 0 else 1.0))
        else:
            out.append((float(ls[0]), float(ls[1]) if ls[1] > 0 else 1.0))
    return n, out[0], out[1]


def solve_overlap_coeffs(nb: int, ref: int, Nij: np.ndarray,
                         Mij: np.ndarray, additive: bool) -> np.ndarray:
    """Per-frame offsets (additive) or scale ratios from the pairwise
    estimators by weighted least squares, the reference frame at the
    identity (normalization.c:296-355)."""
    index = [i for i in range(nb) if i != ref]
    N = nb - 1
    A = np.zeros((N, N))
    B = np.zeros(N)
    for a, ii in enumerate(index):
        if additive:
            B[a] = Nij[ii, ref] * (Mij[ref, ii] - Mij[ii, ref])
        else:
            B[a] = Nij[ii, ref] * Mij[ref, ii] * Mij[ii, ref]
        for b, ij in enumerate(index):
            if ii == ij:
                for k in range(nb):
                    if k != ii:
                        A[a, b] += (Nij[ii, k] if additive
                                    else Nij[ii, k] * Mij[ii, k] ** 2)
            else:
                A[a, b] = (-float(Nij[ii, ij]) if additive
                           else -Nij[ii, ij] * Mij[ii, ij] * Mij[ij, ii])
                if additive:
                    B[a] += Nij[ii, ij] * (Mij[ij, ii] - Mij[ii, ij])
    x = np.linalg.solve(A, B)
    full = np.zeros(nb) if additive else np.ones(nb)
    for a, ii in enumerate(index):
        full[ii] = x[a]
    return full


def compute_overlap_normalization(seq, indices: np.ndarray, mode: int,
                                  lite: bool = False,
                                  reglayer: int = 0) -> NormCoeffs:
    """Normalization of a mosaic (normalization.c:680-925): estimators of
    each pair of frames over their overlap, and a least-squares solve so
    that every frame agrees with its neighbours, anchored at the
    reference frame.  The frames are read on the host."""
    idx = [int(v) for v in indices]
    nb = len(idx)
    L = seq.nb_layers
    offset = np.zeros((L, nb))
    mul = np.ones((L, nb))
    scale = np.ones((L, nb))
    if mode == NO_NORM or nb < 2:
        return NormCoeffs(offset, mul, scale)
    ref_abs = seq.get_reference()
    ref = idx.index(ref_abs) if ref_abs in idx else 0
    layer = min(max(reglayer, 0), L - 1)
    frames = {k: seq.read_frame(k).host() for k in idx}
    Nij = np.zeros((L, nb, nb))
    Mij = np.zeros((L, nb, nb))
    Sij = np.ones((L, nb, nb))
    for a in range(nb):
        for b in range(a + 1, nb):
            ov = compute_overlap(seq, layer, idx[a], idx[b])
            if ov is None:
                continue
            (xi, yi, w, h), (xj, yj, _, _) = ov
            for n in range(L):
                di = frames[idx[a]][n][yi:yi + h, xi:xi + w]
                dj = frames[idx[b]][n][yj:yj + h, xj:xj + w]
                cnt, (la, sa), (lb, sb) = _pair_estimators(di, dj, lite)
                Nij[n, a, b] = Nij[n, b, a] = cnt
                Mij[n, a, b], Mij[n, b, a] = la, lb
                Sij[n, a, b], Sij[n, b, a] = sa, sb
    for n in range(L):
        Mn = Mij[n]
        if mode in (MULTIPLICATIVE_SCALING, ADDITIVE_SCALING):
            scale[n] = solve_overlap_coeffs(nb, ref, Nij[n], Sij[n],
                                            additive=False)
            Mn = Mij[n] * scale[n][:, None]
        if mode in (ADDITIVE, ADDITIVE_SCALING):
            # the kernel computes v·scale − offset and the solved terms
            # are added (normalization.c:894: poffset = −coeffs)
            offset[n] = -solve_overlap_coeffs(nb, ref, Nij[n], Mn,
                                              additive=True)
        elif mode == MULTIPLICATIVE:
            mul[n] = solve_overlap_coeffs(nb, ref, Nij[n], Mn,
                                          additive=False)
    return NormCoeffs(offset, mul, scale)
