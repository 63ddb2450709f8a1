"""Star matching + robust transform estimation — counterpart of
``siril_tpu/registration/matching.py`` (``match_triangles``:77,
``estimate_transform``:127, ``_batched_minimal_H``:198,
``ransac_transform``:276, ``match_stars``:328), host numpy code in
float64, copied so that the same inputs and seed give the same H.

Triangle-space voting (FOCAS/match, atpmatch.c atFindTrans) pairs the
brightest stars of two lists; RANSAC over minimal samples solved all at
once, then an iterative sigma-clipped refit (cvCalculH + atRecalcTrans),
estimates a shift, similarity, affine or homography transform
(registration.h:45-53).
"""

from __future__ import annotations

from dataclasses import dataclass
from itertools import combinations
from typing import Optional

import numpy as np

# transform types (registration.h:45-53)
SHIFT_TRANSFORMATION = 0
SIMILARITY_TRANSFORMATION = 1
AFFINE_TRANSFORMATION = 2
HOMOGRAPHY_TRANSFORMATION = 3

_MIN_PAIRS = {SHIFT_TRANSFORMATION: 1, SIMILARITY_TRANSFORMATION: 2,
              AFFINE_TRANSFORMATION: 3, HOMOGRAPHY_TRANSFORMATION: 4}


@dataclass
class MatchResult:
    H: np.ndarray                    # 3×3, maps frame coords → ref coords
    inliers: int
    pairs: int
    residual_px: float


def _triangles(pts: np.ndarray, max_stars: int = 25):
    """All C(n,3) triangles: points, invariants (b/a, c/a) with a≥b≥c, and
    vertices ordered by descending opposite side."""
    n = min(len(pts), max_stars)
    p = np.asarray(pts[:n], np.float64)
    if n < 3:
        return p, np.zeros((0, 2)), np.zeros((0, 3), np.int32)
    combos = np.array(list(combinations(range(n), 3)), np.int32)
    pi = p[combos[:, 0]]
    pj = p[combos[:, 1]]
    pk = p[combos[:, 2]]
    d_opp = np.stack([
        np.hypot(*(pj - pk).T),
        np.hypot(*(pi - pk).T),
        np.hypot(*(pi - pj).T),
    ], axis=1)
    srt = np.sort(d_opp, axis=1)[:, ::-1]
    a, b, c = srt[:, 0], srt[:, 1], srt[:, 2]
    good = (a > 1e-6) & (c / np.maximum(a, 1e-12) >= 0.05)
    inv = np.stack([b / np.maximum(a, 1e-12),
                    c / np.maximum(a, 1e-12)], axis=1)[good]
    order = np.argsort(-d_opp, axis=1, kind="stable")[good]
    verts = np.take_along_axis(combos[good], order, axis=1)
    return p, inv, verts.astype(np.int32)


def match_triangles(stars_ref: np.ndarray, stars_frame: np.ndarray,
                    max_stars: int = 25, tol: float = 0.01):
    """Triangle-space voting → list of (ref_idx, frame_idx) pairs."""
    pr, inv_r, vr = _triangles(stars_ref, max_stars)
    pf, inv_f, vf = _triangles(stars_frame, max_stars)
    if len(inv_r) == 0 or len(inv_f) == 0:
        return []
    from scipy.spatial import cKDTree

    co = cKDTree(inv_r).sparse_distance_matrix(
        cKDTree(inv_f), tol, output_type="coo_matrix")
    ca, cb = co.row, co.col
    if ca.size == 0:
        return []
    votes = np.zeros((len(pr), len(pf)), np.int32)
    np.add.at(votes, (vr[ca].ravel(), vf[cb].ravel()), 1)
    vmax = int(votes.max())
    if vmax == 0:
        return []
    thresh = max(vmax // 4, 2)
    flat = votes.ravel()
    order = np.argsort(flat)[::-1]
    used_r = np.zeros(len(pr), bool)
    used_f = np.zeros(len(pf), bool)
    pairs = []
    nf = len(pf)
    for k in order:
        if int(flat[k]) < thresh:
            break
        u, v = divmod(int(k), nf)
        if used_r[u] or used_f[v]:
            continue
        used_r[u] = True
        used_f[v] = True
        pairs.append((u, v))
    return pairs


def estimate_transform(src: np.ndarray, dst: np.ndarray,
                       ttype: int = HOMOGRAPHY_TRANSFORMATION) -> np.ndarray:
    """Least-squares transform src→dst (N≥ the minimal set)."""
    if ttype == SHIFT_TRANSFORMATION:
        d = (dst - src).mean(axis=0)
        H = np.eye(3)
        H[0, 2], H[1, 2] = d
        return H
    if ttype == SIMILARITY_TRANSFORMATION:
        cs = src.mean(0)
        cd = dst.mean(0)
        s0 = src - cs
        d0 = dst - cd
        num = (d0[:, 0] * s0[:, 0] + d0[:, 1] * s0[:, 1]).sum()
        cross = (d0[:, 1] * s0[:, 0] - d0[:, 0] * s0[:, 1]).sum()
        den = (s0 ** 2).sum()
        a = num / den
        b = cross / den
        H = np.array([[a, -b, 0.0], [b, a, 0.0], [0, 0, 1.0]])
        t = cd - H[:2, :2] @ cs
        H[0, 2], H[1, 2] = t
        return H
    if ttype == AFFINE_TRANSFORMATION:
        n = len(src)
        A = np.zeros((2 * n, 6))
        bvec = np.zeros(2 * n)
        A[0::2, 0] = src[:, 0]
        A[0::2, 1] = src[:, 1]
        A[0::2, 2] = 1
        A[1::2, 3] = src[:, 0]
        A[1::2, 4] = src[:, 1]
        A[1::2, 5] = 1
        bvec[0::2] = dst[:, 0]
        bvec[1::2] = dst[:, 1]
        x, *_ = np.linalg.lstsq(A, bvec, rcond=None)
        H = np.eye(3)
        H[0] = x[0], x[1], x[2]
        H[1] = x[3], x[4], x[5]
        return H
    # homography via normalized DLT
    def norm(pts):
        c = pts.mean(0)
        s = np.sqrt(2.0) / max(np.hypot(*(pts - c).T).mean(), 1e-9)
        T = np.array([[s, 0, -s * c[0]], [0, s, -s * c[1]], [0, 0, 1]])
        return (pts - c) * s, T

    sn, Ts = norm(src)
    dn, Td = norm(dst)
    n = len(src)
    A = np.zeros((2 * n, 9))
    for i in range(n):
        x, y = sn[i]
        u, v = dn[i]
        A[2 * i] = [-x, -y, -1, 0, 0, 0, u * x, u * y, u]
        A[2 * i + 1] = [0, 0, 0, -x, -y, -1, v * x, v * y, v]
    _, _, Vt = np.linalg.svd(A)
    Hn = Vt[-1].reshape(3, 3)
    H = np.linalg.inv(Td) @ Hn @ Ts
    return H / H[2, 2]


def _apply_h(H, pts):
    ph = np.c_[pts, np.ones(len(pts))]
    q = ph @ H.T
    return q[:, :2] / q[:, 2:3]


def _batched_minimal_H(src: np.ndarray, dst: np.ndarray, picks: np.ndarray,
                       ttype: int) -> np.ndarray:
    """Transforms for EVERY RANSAC sample at once: [iters, 3, 3].

    src/dst: [n, 2]; picks: [iters, m] index samples.  Vectorizing the
    per-sample solve removes the 500-iteration Python loop (~0.07 s per
    frame pair on a 1-core host, the dominant host cost of the fused
    pipeline's registration stage at 100 frames)."""
    it = len(picks)
    s = src[picks]                                   # [it, m, 2]
    d = dst[picks]
    Hs = np.tile(np.eye(3), (it, 1, 1))
    if ttype == SHIFT_TRANSFORMATION:
        t = (d - s).mean(axis=1)                     # [it, 2]
        Hs[:, 0, 2] = t[:, 0]
        Hs[:, 1, 2] = t[:, 1]
        return Hs
    if ttype == SIMILARITY_TRANSFORMATION:
        cs = s.mean(axis=1)                          # [it, 2]
        cd = d.mean(axis=1)
        s0 = s - cs[:, None]
        d0 = d - cd[:, None]
        num = (d0[..., 0] * s0[..., 0] + d0[..., 1] * s0[..., 1]).sum(1)
        cross = (d0[..., 1] * s0[..., 0] - d0[..., 0] * s0[..., 1]).sum(1)
        den = np.maximum((s0 ** 2).sum((1, 2)), 1e-12)
        a = num / den
        b = cross / den
        Hs[:, 0, 0] = a
        Hs[:, 0, 1] = -b
        Hs[:, 1, 0] = b
        Hs[:, 1, 1] = a
        t = cd - np.einsum("kij,kj->ki", Hs[:, :2, :2], cs)
        Hs[:, 0, 2] = t[:, 0]
        Hs[:, 1, 2] = t[:, 1]
        return Hs
    if ttype == AFFINE_TRANSFORMATION:
        # exactly-determined 3-point solve: [x y 1] A^T = dst
        A = np.concatenate([s, np.ones((it, 3, 1))], axis=2)  # [it,3,3]
        ok = np.abs(np.linalg.det(A)) > 1e-9
        sol = np.full((it, 3, 2), np.nan)
        if ok.any():
            sol[ok] = np.linalg.solve(A[ok], d[ok])  # [ok,3,2]
        Hs[:, 0, :] = sol[:, :, 0]
        Hs[:, 1, :] = sol[:, :, 1]
        return Hs
    # homography: batched 8×9 DLT via SVD (smallest right singular vec).
    # Coordinates are Hartley-normalized ONCE per point set (shared by
    # all samples) — raw pixel-scale coords make the DLT matrix
    # hopelessly ill-conditioned (u·x ≈ 1e7 next to 1-entries)
    def norm_T(pts):
        c = pts.mean(0)
        sc = np.sqrt(2.0) / max(np.hypot(*(pts - c).T).mean(), 1e-9)
        return np.array([[sc, 0, -sc * c[0]],
                         [0, sc, -sc * c[1]],
                         [0, 0, 1.0]])

    Ts = norm_T(src)
    Td = norm_T(dst)
    sn = s * Ts[0, 0] + Ts[:2, 2]                    # [it, m, 2]
    dn = d * Td[0, 0] + Td[:2, 2]
    x, y = sn[..., 0], sn[..., 1]                    # [it, 4]
    u, v = dn[..., 0], dn[..., 1]
    z = np.zeros_like(x)
    o = np.ones_like(x)
    r1 = np.stack([-x, -y, -o, z, z, z, u * x, u * y, u], axis=-1)
    r2 = np.stack([z, z, z, -x, -y, -o, v * x, v * y, v], axis=-1)
    A = np.concatenate([r1, r2], axis=1)             # [it, 8, 9]
    _, _, Vt = np.linalg.svd(A)
    Hn = Vt[:, -1, :].reshape(it, 3, 3)
    Hn = np.einsum("ij,kjl,lm->kim", np.linalg.inv(Td), Hn, Ts)
    w = Hn[:, 2, 2]
    bad = np.abs(w) < 1e-12
    w = np.where(bad, 1.0, w)
    Hn = Hn / w[:, None, None]
    Hn[bad] = np.nan
    return Hn


def ransac_transform(src: np.ndarray, dst: np.ndarray,
                     ttype: int = HOMOGRAPHY_TRANSFORMATION,
                     thresh_px: float = 2.0, iters: int = 500,
                     seed: int = 1234) -> Optional[MatchResult]:
    """RANSAC + iterative sigma-clipped refit (cvCalculH + atRecalcTrans).

    The sampling loop is fully vectorized: all ``iters`` minimal-set
    transforms are solved batched, then one [iters, n] residual matrix
    picks the best consensus set."""
    n = len(src)
    m = _MIN_PAIRS[ttype]
    if n < m:
        return None
    if n == m:
        H = estimate_transform(src, dst, ttype)
        res = np.hypot(*(_apply_h(H, src) - dst).T)
        return MatchResult(H, n, n, float(res.mean()))
    rng = np.random.default_rng(seed)
    # sample all picks at once (argsort of uniform noise = one
    # permutation per row, so no duplicate indices within a sample);
    # degenerate/collinear samples yield NaN transforms, masked below
    picks = rng.random((iters, n)).argsort(axis=1)[:, :m]
    Hs = _batched_minimal_H(src, dst, picks, ttype)  # [it, 3, 3]
    ph = np.c_[src, np.ones(n)]                      # [n, 3]
    q = np.einsum("kij,nj->kni", Hs, ph)             # [it, n, 3]
    with np.errstate(invalid="ignore", divide="ignore"):
        proj = q[..., :2] / q[..., 2:3]
        res2 = ((proj - dst[None]) ** 2).sum(-1)     # [it, n]
        inl_all = res2 < thresh_px * thresh_px
    counts = np.where(np.isfinite(Hs).all((1, 2)), inl_all.sum(1), -1)
    best = int(counts.argmax())
    best_cnt = int(counts[best])
    best_inl = inl_all[best]
    if best_cnt < m:
        return None
    # iterative least-squares refit with sigma clipping (atRecalcTrans)
    inl = best_inl
    H = estimate_transform(src[inl], dst[inl], ttype)
    for _ in range(5):
        res = np.hypot(*(_apply_h(H, src) - dst).T)
        sig = max(res[inl].std(), 1e-6)
        new_inl = res < max(3.0 * sig, 0.5)
        if new_inl.sum() < m:
            break
        if (new_inl == inl).all():
            break
        inl = new_inl
        H = estimate_transform(src[inl], dst[inl], ttype)
    res = np.hypot(*(_apply_h(H, src) - dst).T)
    return MatchResult(H, int(inl.sum()), n, float(res[inl].mean()))


def match_stars(stars_ref, stars_frame,
                ttype: int = HOMOGRAPHY_TRANSFORMATION,
                max_stars: int = 25,
                min_pairs: int = 4) -> Optional[MatchResult]:
    """Full star_match_and_checks equivalent: triangle match → RANSAC H.

    ``stars_*``: lists of PSFStar (brightest-first) or (N,2) arrays.
    Returns H mapping FRAME coords → REF coords.
    """
    def to_xy(stars):
        if isinstance(stars, np.ndarray):
            return stars
        return np.array([[s.x0, s.y0] for s in stars])

    pr = to_xy(stars_ref)
    pf = to_xy(stars_frame)
    if len(pr) < 3 or len(pf) < 3:
        return None
    pairs = match_triangles(pr, pf, max_stars)
    if len(pairs) < max(min_pairs, _MIN_PAIRS[ttype]):
        return None
    ridx = np.array([u for u, _ in pairs])
    fidx = np.array([v for _, v in pairs])
    src = pf[fidx]
    dst = pr[ridx]
    result = ransac_transform(src, dst, ttype)
    if result is None:
        return None
    # grow: project ALL frame stars and greedily match to ref within 2px
    proj = _apply_h(result.H, pf)
    d = ((proj[:, None, :] - pr[None, :, :]) ** 2).sum(-1)
    fi, ri = np.nonzero(d < 4.0)
    if len(fi) > result.pairs:
        # unique matches
        seen_f, seen_r = set(), set()
        sf, sr = [], []
        order = np.argsort(d[fi, ri])
        for o in order:
            if fi[o] in seen_f or ri[o] in seen_r:
                continue
            seen_f.add(fi[o])
            seen_r.add(ri[o])
            sf.append(fi[o])
            sr.append(ri[o])
        if len(sf) >= _MIN_PAIRS[ttype]:
            grown = ransac_transform(pf[sf], pr[sr], ttype,
                                     thresh_px=1.5, iters=200)
            if grown is not None and grown.inliers >= result.inliers:
                result = grown
    return result
