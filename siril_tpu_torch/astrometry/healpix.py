"""NESTED HEALPix and HTM (Hierarchical Triangular Mesh) indexing —
counterpart of ``siril_tpu/astrometry/healpix.py`` (``ang2pix_nest``:31,
``nest_parent``:70, ``radec_to_htm``:109, ``image_footprint_pixels``:162,
``image_footprint_trixels``:172); the reference's
``src/io/healpix/healpix_cat.cpp`` cone index of the local Gaia
catalogues and its htmesh subproject (``healpix`` and ``trixel``
commands).  Host numpy, vectorized over the points.
"""

from __future__ import annotations

import numpy as np

# ---------------------------------------------------------------------------
# HEALPix NESTED ang2pix (standard Gorski et al. 2005 algorithm)
# ---------------------------------------------------------------------------

_D2R = np.pi / 180.0


def _interleave_bits(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """Interleave bits of x (even positions) and y (odd) — Morton code."""
    x = x.astype(np.uint64)
    y = y.astype(np.uint64)
    out = np.zeros_like(x)
    for i in range(32):
        out |= ((x >> np.uint64(i)) & np.uint64(1)) << np.uint64(2 * i)
        out |= ((y >> np.uint64(i)) & np.uint64(1)) << np.uint64(2 * i + 1)
    return out


def ang2pix_nest(nside: int, ra_deg, dec_deg) -> np.ndarray:
    """NESTED pixel index for RA/Dec arrays (degrees). nside power of 2."""
    ra = np.atleast_1d(np.asarray(ra_deg, np.float64))
    dec = np.atleast_1d(np.asarray(dec_deg, np.float64))
    z = np.sin(dec * _D2R)
    za = np.abs(z)
    tt = np.mod(ra / 90.0, 4.0)                       # phi in [0,4)

    # equatorial zone |z| <= 2/3
    temp1 = nside * (0.5 + tt)
    temp2 = nside * z * 0.75
    jp = np.floor(temp1 - temp2).astype(np.int64)     # ascending edge
    jm = np.floor(temp1 + temp2).astype(np.int64)     # descending edge
    ifp = jp // nside
    ifm = jm // nside
    face_eq = np.where(ifp == ifm, (ifp & 3) + 4,
                       np.where(ifp < ifm, ifp & 3, (ifm & 3) + 8))
    ix_eq = jm & (nside - 1)
    iy_eq = nside - (jp & (nside - 1)) - 1

    # polar caps
    ntt = np.minimum(3, tt.astype(np.int64))
    tp = tt - ntt
    tmp = nside * np.sqrt(np.maximum(3.0 * (1.0 - za), 0.0))
    jp_p = np.minimum((tp * tmp).astype(np.int64), nside - 1)
    jm_p = np.minimum(((1.0 - tp) * tmp).astype(np.int64), nside - 1)
    north = z >= 0
    face_po = np.where(north, ntt, ntt + 8)
    ix_po = np.where(north, nside - jm_p - 1, jp_p)
    iy_po = np.where(north, nside - jp_p - 1, jm_p)

    eq = za <= 2.0 / 3.0
    face = np.where(eq, face_eq, face_po)
    ix = np.where(eq, ix_eq, ix_po)
    iy = np.where(eq, iy_eq, iy_po)
    return (face.astype(np.uint64) * np.uint64(nside) * np.uint64(nside)
            + _interleave_bits(ix, iy)).astype(np.int64)


def nest_parent(pix, order: int, parent_order: int) -> np.ndarray:
    """Parent pixel of a NESTED pixel at a coarser order."""
    return np.asarray(pix, np.int64) >> (2 * (order - parent_order))


# ---------------------------------------------------------------------------
# HTM — Hierarchical Triangular Mesh (htmesh subproject equivalent)
# ---------------------------------------------------------------------------

# the 8 level-0 faces of the octahedron (names S0-3, N0-3 as in HTM docs)
_V = {
    0: np.array([0.0, 0.0, 1.0]),    # north pole
    1: np.array([1.0, 0.0, 0.0]),
    2: np.array([0.0, 1.0, 0.0]),
    3: np.array([-1.0, 0.0, 0.0]),
    4: np.array([0.0, -1.0, 0.0]),
    5: np.array([0.0, 0.0, -1.0]),   # south pole
}
# (id_base, v0, v1, v2); ids: S0..S3 = 8..11, N0..N3 = 12..15
_FACES = [
    (8, _V[1], _V[5], _V[2]),    # S0
    (9, _V[2], _V[5], _V[3]),    # S1
    (10, _V[3], _V[5], _V[4]),   # S2
    (11, _V[4], _V[5], _V[1]),   # S3
    (12, _V[1], _V[0], _V[4]),   # N0
    (13, _V[4], _V[0], _V[3]),   # N1
    (14, _V[3], _V[0], _V[2]),   # N2
    (15, _V[2], _V[0], _V[1]),   # N3
]


def _radec_to_vec(ra_deg, dec_deg):
    ra = np.asarray(ra_deg, np.float64) * _D2R
    dec = np.asarray(dec_deg, np.float64) * _D2R
    return np.stack([np.cos(dec) * np.cos(ra),
                     np.cos(dec) * np.sin(ra),
                     np.sin(dec)], axis=-1)


def radec_to_htm(ra_deg, dec_deg, level: int = 3) -> np.ndarray:
    """HTM trixel id at the given level (level 3 → 512 trixels, ids
    carrying the 8·4^level offset convention used by htmesh)."""
    p = _radec_to_vec(ra_deg, dec_deg)          # [N,3]
    n = p.shape[0] if p.ndim == 2 else 1
    p = p.reshape(n, 3)
    ids = np.zeros(n, np.int64)
    v0 = np.zeros((n, 3))
    v1 = np.zeros((n, 3))
    v2 = np.zeros((n, 3))
    assigned = np.zeros(n, bool)
    for fid, a, b, c in _FACES:
        # inside test: p on the positive side of each edge plane
        inside = ((np.dot(np.cross(a, b), p.T) >= -1e-12)
                  & (np.dot(np.cross(b, c), p.T) >= -1e-12)
                  & (np.dot(np.cross(c, a), p.T) >= -1e-12)) & ~assigned
        ids[inside] = fid
        v0[inside] = a
        v1[inside] = b
        v2[inside] = c
        assigned |= inside
    for _ in range(level):
        w0 = v1 + v2
        w0 /= np.linalg.norm(w0, axis=1, keepdims=True)
        w1 = v0 + v2
        w1 /= np.linalg.norm(w1, axis=1, keepdims=True)
        w2 = v0 + v1
        w2 /= np.linalg.norm(w2, axis=1, keepdims=True)
        # child 0: (v0, w2, w1); 1: (v1, w0, w2); 2: (v2, w1, w0); 3: middle
        in0 = ((np.einsum('ij,ij->i', np.cross(v0, w2), p) >= -1e-12)
               & (np.einsum('ij,ij->i', np.cross(w2, w1), p) >= -1e-12)
               & (np.einsum('ij,ij->i', np.cross(w1, v0), p) >= -1e-12))
        in1 = ((np.einsum('ij,ij->i', np.cross(v1, w0), p) >= -1e-12)
               & (np.einsum('ij,ij->i', np.cross(w0, w2), p) >= -1e-12)
               & (np.einsum('ij,ij->i', np.cross(w2, v1), p) >= -1e-12))
        in2 = ((np.einsum('ij,ij->i', np.cross(v2, w1), p) >= -1e-12)
               & (np.einsum('ij,ij->i', np.cross(w1, w0), p) >= -1e-12)
               & (np.einsum('ij,ij->i', np.cross(w0, v2), p) >= -1e-12))
        child = np.where(in0, 0, np.where(in1, 1, np.where(in2, 2, 3)))
        ids = ids * 4 + child
        nv0 = np.where(child[:, None] == 0, v0,
               np.where(child[:, None] == 1, v1,
               np.where(child[:, None] == 2, v2, w0)))
        nv1 = np.where(child[:, None] == 0, w2,
               np.where(child[:, None] == 1, w0,
               np.where(child[:, None] == 2, w1, w1)))
        nv2 = np.where(child[:, None] == 0, w1,
               np.where(child[:, None] == 1, w2,
               np.where(child[:, None] == 2, w0, w2)))
        v0, v1, v2 = nv0, nv1, nv2
    return ids


def image_footprint_pixels(wcs, width: int, height: int, nside: int,
                           samples: int = 64) -> np.ndarray:
    """Unique NESTED HEALPix pixels covered by an image (sampled grid)."""
    xs = np.linspace(0, width - 1, samples)
    ys = np.linspace(0, height - 1, samples)
    gx, gy = np.meshgrid(xs, ys)
    ra, dec = wcs.pix2world(gx.ravel(), gy.ravel())
    return np.unique(ang2pix_nest(nside, ra, dec))


def image_footprint_trixels(wcs, width: int, height: int, level: int = 3,
                            samples: int = 64) -> np.ndarray:
    """Unique HTM level-N trixels covered by an image (sampled grid)."""
    xs = np.linspace(0, width - 1, samples)
    ys = np.linspace(0, height - 1, samples)
    gx, gy = np.meshgrid(xs, ys)
    ra, dec = wcs.pix2world(gx.ravel(), gy.ravel())
    return np.unique(radec_to_htm(ra, dec, level))
