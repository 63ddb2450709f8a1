"""Warps — counterpart of ``siril_tpu/ops/interp.py``: the general
gather warp (``_cubic_weights``:45, ``_lanczos_weights``:61,
``_gather_plane``:74, ``sample_plane``:86, ``_warp_body``:135,
``warp_homography_batch``:218, ``warp_homography``:238, ``_dilate3``:258,
``resize``:267, ``_warp_sip_fn``:287, ``warp_homography_sip``:345),
the pure-translation warp (constants :26, ``_shift_batch_fn``:365,
``warp_translation_batch``:460, ``translations_from_Hs``:482) and the FFT
warp ladder of the fused path: the rotation three-shear
(``rotations_from_Hs``:492, ``rot_shear_core``:561,
``warp_rotation_batch``:681), the affine chirp-Z (``_mod2_exact``:738,
``_cis_pi``:765, ``_czt_resample_last``:772, ``_sig_pair``:836,
``_fold_gate_inverse_affine``:844, ``_czt_sigmas``:869,
``affines_from_Hs``:876, ``_affine_czt_passes``:918,
``affine_czt_core``:942, ``warp_affine_batch``:992) and the perspective
split (``_shift_resample_last``:1054, ``perspective_split_from_Hs``:1086,
``perspective_czt_core``:1182, ``warp_perspective_batch``:1266).

The gather warp (the staged ``register`` and ``seqapplyreg``): for each
output pixel the source coordinate H⁻¹·x, then nearest, bilinear
(area), bicubic (a = −0.75) or lanczos4 taps gathered and summed in
float32, out-of-frame taps reading 0; rows are warped in blocks so that
a 4096² lanczos4 warp keeps each tap's index tensor to one block.  The
clamp substitutes the bilinear guide where the result undershoots
0.98·guide, dilated 3×3 with wrap-around (opencv.cpp:264-276).  The
SIP warp (``-disto``) is the same pass with the source coordinates moved
by a master's distortion polynomials, eager float32 torch ops on the
device (about 20 a term-pair and order; three times that to invert).

The integer part of a shift is a padded slice, the fractional part a
separable 8-tap lanczos4 (4-tap cubic, 2-tap for the other methods)
filter written as explicit weighted sums of shifted slices, in float32 —
no convolution, so cuDNN's TF32 does not apply.

The ladder interpolates with exact sinc through batched 1-D FFTs
(``torch.fft``) and elementwise phases; the gates (numpy, float64) pick
the cheapest rung whose family holds every frame's homography, and the
clamp guide is a bilinear filter (rotation: a transfer function; affine
and perspective: a 4-tap gather of the original frames).  The chirp
phases are reduced mod 2 from split products (``_mod2_exact``): each
product must round on its own, which eager torch ops do and a fused
multiply-add would not, so this code is never compiled or fused.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

INTERP_NEAREST = 0
INTERP_BILINEAR = 1
INTERP_BICUBIC = 2
INTERP_LANCZOS4 = 3
INTERP_AREA = 4
INTERP_NONE = 5

INTERP_NAMES = {"ne": INTERP_NEAREST, "nearest": INTERP_NEAREST,
                "bi": INTERP_BILINEAR, "bilinear": INTERP_BILINEAR,
                "bc": INTERP_BICUBIC, "cubic": INTERP_BICUBIC,
                "bicubic": INTERP_BICUBIC,
                "la": INTERP_LANCZOS4, "lanczos4": INTERP_LANCZOS4,
                "lanczos": INTERP_LANCZOS4,
                "ar": INTERP_AREA, "area": INTERP_AREA,
                "no": INTERP_NONE, "none": INTERP_NONE}

CLAMPING_FACTOR = 0.98

#: output pixels of one row block of the gather warp
WARP_BLOCK_PIXELS = 1 << 22

#: taps a side of the translation warp's separable filter: every method
#: but lanczos4 and bicubic shifts with two taps weighted (1 − t, t)
#: (siril_tpu/ops/interp.py:385-404)
_TAPS = {INTERP_LANCZOS4: 4, INTERP_BICUBIC: 2}


def _frac_weights(t: np.float32, method: int, A: int) -> list:
    """Filter weights of the 2A taps for fractional offset t, computed in
    float32 like the reference, returned as Python floats."""
    t = torch.tensor(t, dtype=torch.float32)
    x = t - torch.arange(-A + 1, A + 1, dtype=torch.float32)
    if method == INTERP_LANCZOS4:
        pix = float(np.float32(np.pi)) * x
        w = torch.where(torch.abs(x) < 1e-7, 1.0,
                        A * torch.sin(pix) * torch.sin(pix / A) / (pix * pix))
        w = torch.where(torch.abs(x) < A, w, 0.0)
    elif method == INTERP_BICUBIC:
        a = -0.75
        ax = torch.abs(x)
        w = torch.where(ax <= 1.0, ((a + 2.0) * ax - (a + 3.0)) * ax * ax
                        + 1.0,
                        torch.where(ax < 2.0, ((ax - 5.0) * ax + 8.0) * ax * a
                                    - 4.0 * a, 0.0))
    else:
        w = torch.stack([1.0 - t, t])
    return (w / w.sum()).tolist()


def _dilate3(mask: torch.Tensor) -> torch.Tensor:
    """3×3 dilation with wrap-around at the borders (as the reference's
    roll-based dilation)."""
    m = mask
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            m = m | torch.roll(mask, shifts=(dy, dx), dims=(-2, -1))
    return m


def _shift_one(fr: torch.Tensor, dx: float, dy: float, method: int,
               clamp: bool, margin: int) -> torch.Tensor:
    """out(x) = in(x − d) for one (C, H, W) frame; outside is zero."""
    A = _TAPS.get(method, 1)
    C, H, W = fr.shape
    pad = margin + A + 1
    sx = np.float32(-dx)
    sy = np.float32(-dy)
    ix = int(np.clip(np.floor(sx), -margin, margin))
    iy = int(np.clip(np.floor(sy), -margin, margin))
    fx = np.float32(sx - np.float32(ix))
    fy = np.float32(sy - np.float32(iy))
    big = F.pad(fr, (pad, pad, pad, pad))
    y0 = pad + iy - (A - 1)
    x0 = pad + ix - (A - 1)
    base = big[:, y0:y0 + H + 2 * A, x0:x0 + W + 2 * A]
    wx = _frac_weights(fx, method, A)
    wy = _frac_weights(fy, method, A)
    accy = torch.zeros((C, H, W + 2 * A), dtype=torch.float32,
                       device=fr.device)
    for k in range(2 * A):
        accy = accy + wy[k] * base[:, k:k + H, :]
    acc = torch.zeros((C, H, W), dtype=torch.float32, device=fr.device)
    for k in range(2 * A):
        acc = acc + wx[k] * accy[:, :, k:k + W]
    if clamp and method in (INTERP_BICUBIC, INTERP_LANCZOS4):
        gy = float(np.float32(1.0) - fy) * base[:, A - 1:A - 1 + H, :] + \
            float(fy) * base[:, A:A + H, :]
        guide = float(np.float32(1.0) - fx) * gy[:, :, A - 1:A - 1 + W] + \
            float(fx) * gy[:, :, A:A + W]
        mask = _dilate3(acc < CLAMPING_FACTOR * guide)
        acc = torch.where(mask, guide, acc)
    return acc


def warp_translation_batch(frames: torch.Tensor, shifts,
                           method: int = INTERP_LANCZOS4,
                           clamp: bool = False) -> torch.Tensor:
    """Warp a (N, C, H, W) batch by per-frame translations ``shifts``
    (N, 2) frame→ref (dx, dy): out(x) = in(x − d).  Frames are warped one
    at a time into a new tensor."""
    sh = np.asarray(shifts, np.float32)
    need = int(np.ceil(np.abs(sh).max())) + 1 if sh.size else 1
    margin = 32
    while margin < need:
        margin *= 2
    out = torch.empty_like(frames)
    for i in range(frames.shape[0]):
        out[i] = _shift_one(frames[i], float(sh[i, 0]), float(sh[i, 1]),
                            method, clamp, margin)
    return out


def translations_from_Hs(Hs, atol: float = 1e-9) -> Optional[np.ndarray]:
    """(N, 2) translations if every H is a pure translation, else None."""
    Hs = np.asarray(Hs)
    if not np.allclose(Hs[:, :2, :2], np.eye(2)[None], atol=atol):
        return None
    if not np.allclose(Hs[:, 2, :2], 0.0, atol=atol):
        return None
    return Hs[:, :2, 2].copy()


def _cubic_weights(t: torch.Tensor, a: float = -0.75) -> torch.Tensor:
    """OpenCV cubic weights of the taps at −1, 0, 1, 2 around t ∈ [0, 1)."""
    x = torch.stack([t + 1.0, t, 1.0 - t, 2.0 - t])
    ax = torch.abs(x)
    return torch.where(
        ax <= 1.0, ((a + 2.0) * ax - (a + 3.0)) * ax * ax + 1.0,
        torch.where(ax < 2.0, ((ax - 5.0) * ax + 8.0) * ax * a - 4.0 * a,
                    0.0))


def _lanczos_weights(t: torch.Tensor, A: int = 4) -> torch.Tensor:
    """Normalized lanczos weights of the taps at −A+1 … A around t."""
    offs = torch.arange(-A + 1, A + 1, dtype=torch.float32,
                        device=t.device)
    x = t[None] - offs.reshape((-1,) + (1,) * t.ndim)
    pix = float(np.float32(np.pi)) * x
    w = torch.where(torch.abs(x) < 1e-7, 1.0,
                    A * torch.sin(pix) * torch.sin(pix / A) / (pix * pix))
    w = torch.where(torch.abs(x) < A, w, 0.0)
    return w / torch.sum(w, dim=0)


def _gather_plane(plane: torch.Tensor, yi: torch.Tensor,
                  xi: torch.Tensor) -> torch.Tensor:
    """plane[yi, xi], 0 outside the frame."""
    H, W = plane.shape
    inb = (yi >= 0) & (yi < H) & (xi >= 0) & (xi < W)
    v = plane.reshape(-1)[yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1)]
    return torch.where(inb, v, 0.0)


def sample_plane(plane: torch.Tensor, sy: torch.Tensor, sx: torch.Tensor,
                 method: int) -> torch.Tensor:
    """Sample an (H, W) plane at float32 coordinates (sy, sx); taps
    outside the frame read 0 (the stack's black fill)."""
    if method in (INTERP_NEAREST, INTERP_NONE):
        return _gather_plane(plane, torch.round(sy).long(),
                             torch.round(sx).long())
    y0 = torch.floor(sy)
    x0 = torch.floor(sx)
    ty = sy - y0
    tx = sx - x0
    y0i = y0.long()
    x0i = x0.long()
    if method in (INTERP_BILINEAR, INTERP_AREA):
        taps, wy, wx = 2, torch.stack([1.0 - ty, ty]), \
            torch.stack([1.0 - tx, tx])
        first = 0
    elif method == INTERP_BICUBIC:
        taps, wy, wx, first = 4, _cubic_weights(ty), _cubic_weights(tx), -1
    elif method == INTERP_LANCZOS4:
        taps, wy, wx, first = 8, _lanczos_weights(ty), \
            _lanczos_weights(tx), -3
    else:
        raise ValueError(f"bad interpolation {method}")
    acc = torch.zeros_like(sy)
    for iy in range(taps):
        for ix in range(taps):
            v = _gather_plane(plane, y0i + iy + first, x0i + ix + first)
            acc = acc + v * wy[iy] * wx[ix]
    return acc


def _warp_body(planes: torch.Tensor, Hinv: np.ndarray, out_h: int,
               out_w: int, method: int, clamp: bool,
               displace=None) -> torch.Tensor:
    """(C, H, W) planes and one float32 H⁻¹ → (C, out_h, out_w);
    ``displace(sx, sy)`` (the SIP warp's) moves the source coordinates
    before they are sampled."""
    dev = planes.device
    h = [float(v) for v in np.asarray(Hinv, np.float32).ravel()]
    want_clamp = clamp and method in (INTERP_BICUBIC, INTERP_LANCZOS4)
    rows = max(1, min(out_h, WARP_BLOCK_PIXELS // max(out_w, 1)))
    xf = torch.arange(out_w, dtype=torch.float32, device=dev)[None]
    out = torch.empty((planes.shape[0], out_h, out_w), dtype=torch.float32,
                      device=dev)
    guide = torch.empty_like(out) if want_clamp else None
    for y0 in range(0, out_h, rows):
        y1 = min(out_h, y0 + rows)
        yf = torch.arange(y0, y1, dtype=torch.float32, device=dev)[:, None]
        d = h[6] * xf + h[7] * yf + h[8]
        sx = (h[0] * xf + h[1] * yf + h[2]) / d
        sy = (h[3] * xf + h[4] * yf + h[5]) / d
        if displace is not None:
            sx, sy = displace(sx, sy)
        for c in range(planes.shape[0]):
            out[c, y0:y1] = sample_plane(planes[c], sy, sx, method)
            if want_clamp:
                guide[c, y0:y1] = sample_plane(planes[c], sy, sx,
                                               INTERP_BILINEAR)
    if want_clamp:
        mask = _dilate3(out < CLAMPING_FACTOR * guide)
        out = torch.where(mask, guide, out)
    return out


def warp_homography(data: torch.Tensor, H, out_shape,
                    method: int = INTERP_LANCZOS4,
                    clamp: bool = True) -> torch.Tensor:
    """Warp a (C, H, W) float32 tensor by the 3×3 homography ``H``
    (source → target): out(x) = in(H⁻¹·x), black outside
    (cvTransformImage), on the tensor's device."""
    Hinv = np.linalg.inv(np.asarray(H, np.float64))
    return _warp_body(data.float(), Hinv, int(out_shape[0]),
                      int(out_shape[1]), int(method), bool(clamp))


def _sip_displacer(sip_a, sip_b, frame, invert: bool):
    """``displace(sx, sy)`` of a SIP distortion in float32: the
    polynomials are evaluated at u = x − x0, v = ysign·(y − y0) (``frame``,
    ``ops/wcs.sip_frame``), A moves x and ysign·B the top-down row.
    ``invert`` solves s + P(s) = x by three fixed-point (Newton) steps."""
    order = int(sip_a.shape[0]) - 1
    terms = [(p, q, float(np.float32(sip_a[p, q])),
              float(np.float32(sip_b[p, q])))
             for p in range(order + 1) for q in range(order + 1 - p)
             if sip_a[p, q] != 0.0 or sip_b[p, q] != 0.0]
    x0, y0, ysign = (float(np.float32(v)) for v in frame)

    def poly(px, py):
        u = px - x0
        v = (py - y0) * ysign
        up, vp = [None, u], [None, v]
        for k in range(2, order + 1):
            up.append(up[-1] * u)
            vp.append(vp[-1] * v)
        du = torch.zeros_like(u)
        dv = torch.zeros_like(v)
        for p, q, a, b in terms:
            t = up[p] if q == 0 else vp[q] if p == 0 else up[p] * vp[q]
            if a != 0.0:
                du = du + a * t
            if b != 0.0:
                dv = dv + b * t
        return du, dv * ysign

    def displace(sx, sy):
        if not terms:
            return sx, sy
        if invert:
            cx, cy = sx, sy
            for _ in range(3):
                du, dv = poly(cx, cy)
                cx = sx - du
                cy = sy - dv
            return cx, cy
        du, dv = poly(sx, sy)
        return sx + du, sy + dv

    return displace


def warp_homography_sip(data: torch.Tensor, H, sip_a, sip_b, frame,
                        out_shape, method: int = INTERP_LANCZOS4,
                        clamp: bool = True,
                        invert: bool = False) -> torch.Tensor:
    """The gather warp with a SIP distortion in the same sampling pass
    (``register`` / ``seqapplyreg -disto=``, registration/distorsion.c's
    pixmap): each output pixel's source coordinate H⁻¹·x is moved by the
    polynomials (``invert=False``: A/B are the displacement to apply, the
    master's AP/BP) or by their inverse (``invert=True``: A/B are the
    forward distortion), then sampled as ``warp_homography`` samples, in
    the same float32 order, so that with no SIP term both are equal bit
    for bit.  ``frame`` = (x0, y0, ysign) places the polynomials
    (``ops/wcs.sip_frame``: FITS bottom-up v, as ``WCS.pix2world``)."""
    Hinv = np.linalg.inv(np.asarray(H, np.float64))
    return _warp_body(data.float(), Hinv, int(out_shape[0]),
                      int(out_shape[1]), int(method), bool(clamp),
                      _sip_displacer(np.asarray(sip_a, np.float64),
                                     np.asarray(sip_b, np.float64), frame,
                                     bool(invert)))


def warp_homography_batch(frames: torch.Tensor, Hs, out_shape,
                          method: int = INTERP_LANCZOS4,
                          clamp: bool = True) -> torch.Tensor:
    """Warp an (N, C, H, W) batch by per-frame homographies (N, 3, 3)."""
    Hs = np.asarray(Hs, np.float64)
    return torch.stack([warp_homography(frames[i], Hs[i], out_shape,
                                        method, clamp)
                        for i in range(frames.shape[0])])


def resize(data: torch.Tensor, to_w: int, to_h: int,
           method: int = INTERP_BILINEAR, clamp: bool = False
           ) -> torch.Tensor:
    """Scale a (C, H, W) tensor to (C, to_h, to_w) with the gather warp
    (cvResizeGaussian): pixel centres aligned, src = (dst + 0.5)·s − 0.5
    (``siril_tpu/ops/interp.py:267``)."""
    c, h, w = data.shape
    sx, sy = w / to_w, h / to_h
    Hinv = np.array([[sx, 0, 0.5 * sx - 0.5],
                     [0, sy, 0.5 * sy - 0.5],
                     [0, 0, 1.0]])
    return warp_homography(data, np.linalg.inv(Hinv), (to_h, to_w), method,
                           clamp)


# ---------------------------------------------------------------------------
# the FFT warp ladder (fused path): gates on the host, rungs on the device
# ---------------------------------------------------------------------------

#: float32 π, as the reference's jnp.pi meets float32 arrays
_PI32 = float(np.float32(np.pi))


def _corners(size) -> np.ndarray:
    Hi, Wi = int(size[0]), int(size[1])
    return np.array([[0.0, 0.0, 1.0], [Wi - 1.0, 0.0, 1.0],
                     [0.0, Hi - 1.0, 1.0], [Wi - 1.0, Hi - 1.0, 1.0]])


def rotations_from_Hs(Hs, size, max_err_px: float = 0.15,
                      max_deg: float = 15.0):
    """(p, q, t, flip) of the INVERSE maps src = M·dst + t,
    M = [[p, q], [−q, p]], if every H is a rotation plus translation
    within ``max_err_px`` at the four corners (the nearest rotation of
    each 2×2 block against the full projective map), else None.  Frames
    turned by about 180° (a meridian flip) are folded: the double flip is
    exact, and only the residual angle, at most ``max_deg``, is sheared."""
    Hs = np.asarray(Hs, np.float64)
    if not np.isfinite(Hs).all() or (np.abs(Hs[:, 2, 2]) < 1e-12).any():
        return None
    Hs = Hs / Hs[:, 2:3, 2:3]
    A = Hs[:, :2, :2]
    p = (A[:, 0, 0] + A[:, 1, 1]) / 2.0
    q = (A[:, 0, 1] - A[:, 1, 0]) / 2.0
    nrm = np.hypot(p, q)
    if (nrm < 0.5).any():                    # reflection / degenerate
        return None
    p, q = p / nrm, q / nrm
    theta = np.arctan2(q, p)
    flip = np.abs(theta) > np.pi / 2
    resid = np.where(flip, theta - np.sign(theta) * np.pi, theta)
    if np.abs(resid).max() > np.deg2rad(max_deg):
        return None
    Hi, Wi = int(size[0]), int(size[1])
    corners = _corners(size)
    full = np.einsum("nij,cj->nci", Hs, corners)
    w = full[..., 2]
    if (np.abs(w) < 1e-6).any():
        return None
    full = full[..., :2] / w[..., None]
    t = Hs[:, :2, 2]
    M = np.stack([np.stack([p, q], -1), np.stack([-q, p], -1)], -2)
    snap = np.einsum("nij,cj->nci", M, corners[:, :2]) + t[:, None, :]
    err = np.hypot(*(full - snap).transpose(2, 0, 1))
    if not np.isfinite(err).all() or err.max() > max_err_px:
        return None
    # exact rotation inverse: Mi = Mᵀ, ti = −Mᵀ·t; a flipped frame is
    # warped double-flipped by (−p, −q, s − t), s = (W−1, H−1)
    pi_, qi = p, -q
    Mi = np.stack([np.stack([pi_, qi], -1), np.stack([-qi, pi_], -1)], -2)
    ti = -np.einsum("nij,nj->ni", Mi, t)
    s_vec = np.array([Wi - 1.0, Hi - 1.0])
    pe = np.where(flip, -pi_, pi_)
    qe = np.where(flip, -qi, qi)
    te = np.where(flip[:, None], s_vec[None] - ti, ti)
    return (pe.astype(np.float32), qe.astype(np.float32),
            te.astype(np.float32), flip)


def _flip_frames(frames: torch.Tensor, flip: torch.Tensor) -> torch.Tensor:
    """Frames whose ``flip`` is set turned by 180° (both axes reversed)."""
    if not bool(flip.any()):
        return frames
    return torch.where(flip[:, None, None, None],
                       torch.flip(frames, (-2, -1)), frames)


def rot_shear_core(frames: torch.Tensor, p, q, t, flipmask,
                   clamp: bool = True) -> torch.Tensor:
    """Rotation + translation of (N, C, H, W) float32 frames by the Paeth
    three-shear R = Sx(α)·Sy(β)·Sx(α), α = tan(θ/2), β = −sin θ, each
    shear a per-line shift by an FFT phase ramp (sinc).  With ``clamp``
    the same shears run with the bilinear transfer function on a second
    copy, the guide of the ringing clamp.  Pixels whose source lies
    outside the frame are 0.  ``p``, ``q`` (N,), ``t`` (N, 2) float32
    tensors and ``flipmask`` (N,) bool, from ``rotations_from_Hs``."""
    H, W = (int(d) for d in frames.shape[-2:])
    cy, cx = (H - 1) / 2.0, (W - 1) / 2.0
    dev = frames.device

    def transfers(s, n):
        # sinc shift e^{iωs}; bilinear ((1−f) + f·e^{iω})·e^{iωs0}
        k = torch.arange(n // 2 + 1, dtype=torch.float32, device=dev)
        w = (2j * math.pi / n) * k
        out = [torch.exp(w * s[..., None])]
        if clamp:
            s0 = torch.floor(s)
            f = (s - s0)[..., None]
            out.append(((1.0 - f) + f * torch.exp(w))
                       * torch.exp(w * s0[..., None]))
        return out

    def shift_last(imgs, s):
        # out[..., x] = img[..., x + s]: the main image through the sinc
        # transfer, the guide (the last image) through the bilinear one
        n = imgs[0].shape[-1]
        phases = transfers(s, n)
        spec = torch.fft.rfft(imgs[0], dim=-1)
        outs = [torch.fft.irfft(spec * phases[0], n=n, dim=-1)]
        if clamp:
            if imgs[-1] is not imgs[0]:
                spec = torch.fft.rfft(imgs[-1], dim=-1)
            outs.append(torch.fft.irfft(spec * phases[1], n=n, dim=-1))
        return outs

    def shift_cols(imgs, s):
        outs = shift_last([i.transpose(-1, -2) for i in imgs], s)
        return [o.transpose(-1, -2) for o in outs]

    frames = _flip_frames(frames, flipmask)
    txp = p * cx + q * cy - cx + t[:, 0]
    typ = -q * cx + p * cy - cy + t[:, 1]
    theta = torch.atan2(q, p)
    alpha = torch.tan(theta / 2.0)
    yy = torch.arange(H, dtype=torch.float32, device=dev) - cy
    xx = torch.arange(W, dtype=torch.float32, device=dev) - cx
    s1 = alpha[:, None] * yy[None] + (txp - alpha * typ)[:, None]
    s2 = -q[:, None] * xx[None] + typ[:, None]
    s3 = alpha[:, None] * yy[None]
    g = shift_last([frames, frames] if clamp else [frames], s1[:, None, :])
    g = shift_cols(g, s2[:, None, :])
    g = shift_last(g, s3[:, None, :])
    out = g[0]
    if clamp:
        mask = _dilate3(out < CLAMPING_FACTOR * g[-1])
        out = torch.where(mask, g[-1], out)
    dx = xx[None, None, :]
    dy = yy[None, :, None]
    sx = (p[:, None, None] * dx + q[:, None, None] * dy
          + (cx + txp)[:, None, None])
    sy = (-q[:, None, None] * dx + p[:, None, None] * dy
          + (cy + typ)[:, None, None])
    ok = (sx >= 0.0) & (sx <= W - 1.0) & (sy >= 0.0) & (sy <= H - 1.0)
    return out * ok[:, None, :, :]


def _run_chunked(run, frames: torch.Tensor, budget: int,
                 *arrays) -> torch.Tensor:
    """``run(frames_chunk, *per_frame_chunks)`` over chunks of frames
    holding at most ``budget`` bytes of float32 (one frame at least), into
    a new tensor."""
    px = int(np.prod(frames.shape[1:]))
    chunk = max(budget // max(px * 4, 1), 1)
    out = torch.empty_like(frames)
    for s in range(0, frames.shape[0], chunk):
        e = min(s + chunk, frames.shape[0])
        out[s:e] = run(frames[s:e], *(a[s:e] for a in arrays))
    return out


def _f32(a, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, np.float32), device=device)


def _flags(a, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, bool), device=device)


def warp_rotation_batch(frames: torch.Tensor, rot,
                        clamp: bool = True) -> torch.Tensor:
    """Warp (N, C, H, W) frames by the (p, q, t, flip) of
    ``rotations_from_Hs`` with the three-shear, in chunks of 64 MiB of
    frames (the FFT transients are about 4× the chunk)."""
    p, q, t, flip = rot
    dev = frames.device
    return _run_chunked(lambda fr, *a: rot_shear_core(fr, *a, clamp=clamp),
                        frames, 64 << 20, _f32(p, dev), _f32(q, dev),
                        _f32(t, dev), _flags(flip, dev))


def _mod2_exact(a_hi: torch.Tensor, a_lo: torch.Tensor,
                i: torch.Tensor) -> torch.Tensor:
    """((a_hi + a_lo)·i) mod 2 for an exact int32 ``i`` (|i| < 2²⁷) and a
    float64 coefficient carried as a float32 pair: i split at bit 14, a_hi
    by Veltkamp at 13 bits, so that the one large product is exact and
    the others are small; each product and sum rounds on its own."""
    def mod2(x):
        return x - 2.0 * torch.floor(x * 0.5)

    i_hi = ((i >> 14) << 14).float()
    i_lo = (i & 16383).float()
    c = a_hi * 8193.0
    a1 = c - (c - a_hi)
    a2 = a_hi - a1
    t = mod2(a1 * i_hi) + mod2(a1 * i_lo) + mod2(a2 * i_hi) \
        + mod2(a2 * i_lo) + a_lo * (i_hi + i_lo)
    return mod2(t)


def _cis_pi(x: torch.Tensor) -> torch.Tensor:
    """e^{iπx} (complex64) from a mod-2 phase."""
    return torch.exp((1j * math.pi) * x).to(torch.complex64)


def _czt_resample_last(img: torch.Tensor, s: torch.Tensor,
                       sig_hi: torch.Tensor,
                       sig_lo: torch.Tensor) -> torch.Tensor:
    """Sinc resample along the last axis by Bluestein's chirp-Z:
    out[..., r, k] = in(σ·k + s[..., r]), σ per frame (the float32 pair
    ``sig_hi``/``sig_lo`` (N,) of σ/W), ``s`` broadcastable to
    img[..., :-1].  The convolution runs at the power of two L ≥ 2W − 1;
    columns whose source is outside the line are not masked here."""
    W = int(img.shape[-1])
    M0 = W // 2
    L = 1 << int(np.ceil(np.log2(max(2 * W - 1, 2))))
    dev = img.device
    nd = img.dim()
    shp = (slice(None),) + (None,) * (nd - 1)
    shq = (slice(None),) + (None,) * (nd - 2) + (slice(None),)
    IN = torch.roll(torch.fft.fft(img.to(torch.complex64), dim=-1), M0,
                    dims=-1)
    m = torch.arange(W, dtype=torch.int32, device=dev)
    ch_m = _cis_pi(_mod2_exact(sig_hi[shp], sig_lo[shp], (m * m)[None]))
    mf = m.float()
    ph_s = torch.exp((2j * math.pi / W) * mf * s[..., None]).to(
        torch.complex64)
    P = IN * ph_s * ch_m
    j_neg = torch.arange(-(W - 1), 0, dtype=torch.int32, device=dev)
    q_pos = _cis_pi(-_mod2_exact(sig_hi[:, None], sig_lo[:, None],
                                 (m * m)[None]))
    q_neg = _cis_pi(-_mod2_exact(sig_hi[:, None], sig_lo[:, None],
                                 (j_neg * j_neg)[None]))
    qz = torch.zeros((sig_hi.shape[0], L - 2 * W + 1),
                     dtype=torch.complex64, device=dev)
    Q = torch.fft.fft(torch.cat([q_pos, qz, q_neg], dim=-1), dim=-1)
    conv = torch.fft.ifft(torch.fft.fft(P, n=L, dim=-1) * Q[shq],
                          dim=-1)[..., :W]
    ch_k = _cis_pi(_mod2_exact(sig_hi[shp], sig_lo[shp], (m * m)[None]))
    ch_k = ch_k * _cis_pi(-_mod2_exact(sig_hi[shp], sig_lo[shp],
                                       (2 * M0 * m)[None]))
    ph_r = torch.exp((-2j * math.pi * M0 / W) * s[..., None]).to(
        torch.complex64)
    return (conv * ch_k * ph_r).real / W


def _sig_pair(sigma):
    """Float64 σ/W → float32 pair (hi, lo) over frames."""
    hi = np.asarray(sigma, np.float64).astype(np.float32)
    lo = (np.asarray(sigma, np.float64) - hi.astype(np.float64)).astype(
        np.float32)
    return hi, lo


def _fold_gate_inverse_affine(Mi, bi, size, scale_band, max_shear):
    """Fold near-180° inverse affines (negative trace: double flip, so
    that both pass scales are near +1) and gate the chirp-Z passes' scales
    and shears (Catmull-Smith bottleneck).  Returns (Mf, bf, flip) or
    None."""
    Hi, Wi = int(size[0]), int(size[1])
    flip = (Mi[:, 0, 0] + Mi[:, 1, 1]) < 0.0
    s_vec = np.array([Wi - 1.0, Hi - 1.0])
    Mf = np.where(flip[:, None, None], -Mi, Mi)
    bf = np.where(flip[:, None], s_vec[None] - bi, bi)
    m00, m01 = Mf[:, 0, 0], Mf[:, 0, 1]
    m10, m11 = Mf[:, 1, 0], Mf[:, 1, 1]
    detf = m00 * m11 - m01 * m10
    if (np.abs(m11) < 1e-9).any() or (np.abs(detf) < 1e-9).any():
        return None
    e = detf / m11
    lo, hi = 1.0 - scale_band, 1.0 + scale_band
    if ((e < lo) | (e > hi) | (m11 < lo) | (m11 > hi)
            | (np.abs(m01 / m11) > max_shear)
            | (np.abs(m10) > max_shear)).any():
        return None
    return Mf, bf, flip


def _czt_sigmas(M, H, W):
    """Float32 pairs of the two chirp-Z pass scales, σx/W and σy/H."""
    m11 = M[:, 1, 1]
    det = M[:, 0, 0] * m11 - M[:, 0, 1] * M[:, 1, 0]
    return _sig_pair(det / m11 / W), _sig_pair(m11 / H)


def affines_from_Hs(Hs, size, max_err_px: float = 0.15,
                    scale_band: float = 0.25, max_shear: float = 0.25):
    """(M, b, flip) of the flip-folded inverse affines src = M·dst + b if
    every H is affine within ``max_err_px`` at the corners and both pass
    scales lie within ±``scale_band`` of 1 and the shears within
    ``max_shear``, else None."""
    Hs = np.asarray(Hs, np.float64)
    if not np.isfinite(Hs).all() or (np.abs(Hs[:, 2, 2]) < 1e-12).any():
        return None
    Hs = Hs / Hs[:, 2:3, 2:3]
    corners = _corners(size)
    full = np.einsum("nij,cj->nci", Hs, corners)
    w = full[..., 2]
    if (np.abs(w) < 1e-6).any():
        return None
    full = full[..., :2] / w[..., None]
    A = Hs[:, :2, :2]
    t = Hs[:, :2, 2]
    aff = np.einsum("nij,cj->nci", A, corners[:, :2]) + t[:, None, :]
    err = np.hypot(*(full - aff).transpose(2, 0, 1))
    if not np.isfinite(err).all() or err.max() > max_err_px:
        return None
    det = A[:, 0, 0] * A[:, 1, 1] - A[:, 0, 1] * A[:, 1, 0]
    if (np.abs(det) < 1e-9).any():
        return None
    Mi = np.stack([np.stack([A[:, 1, 1], -A[:, 0, 1]], -1),
                   np.stack([-A[:, 1, 0], A[:, 0, 0]], -1)],
                  -2) / det[:, None, None]
    bi = -np.einsum("nij,nj->ni", Mi, t)
    return _fold_gate_inverse_affine(Mi, bi, size, scale_band, max_shear)


def _affine_czt_passes(frames: torch.Tensor, M: torch.Tensor,
                       b: torch.Tensor, sig_x, sig_y) -> torch.Tensor:
    """The two chirp-Z passes of a flip-folded affine: rows src_x =
    e·x + g·y + t1, then columns src_y = f·y + m10·x + by; no clamp and
    no validity mask."""
    H, W = (int(d) for d in frames.shape[-2:])
    dev = frames.device
    m10 = M[:, 1, 0]
    bx, by = b[:, 0], b[:, 1]
    g = M[:, 0, 1] / M[:, 1, 1]
    t1 = bx - g * by
    yy = torch.arange(H, dtype=torch.float32, device=dev)
    xx = torch.arange(W, dtype=torch.float32, device=dev)
    s_row = g[:, None] * yy[None] + t1[:, None]
    out = _czt_resample_last(frames, s_row[:, None, :], *sig_x)
    s_col = m10[:, None] * xx[None] + by[:, None]
    outT = _czt_resample_last(out.transpose(-1, -2), s_col[:, None, :],
                              *sig_y)
    return outT.transpose(-1, -2)


def _bilinear_guide(frames: torch.Tensor, sy: torch.Tensor,
                    sx: torch.Tensor) -> torch.Tensor:
    """Bilinear samples of every plane of (N, C, H, W) frames at each
    frame's (H, W) source map (sy, sx): the clamp guide."""
    return torch.stack([torch.stack([
        sample_plane(pl, sy[k], sx[k], INTERP_BILINEAR) for pl in fr])
        for k, fr in enumerate(frames)])


def _clamp_to_guide(out: torch.Tensor, guide: torch.Tensor) -> torch.Tensor:
    mask = _dilate3(out < CLAMPING_FACTOR * guide)
    return torch.where(mask, guide, out)


def affine_czt_core(frames: torch.Tensor, M, b, flipmask, sig_x, sig_y,
                    clamp: bool = True) -> torch.Tensor:
    """Two-pass chirp-Z affine warp of (N, C, H, W) frames by the
    flip-folded inverse affines ``M`` (N, 2, 2), ``b`` (N, 2) (float32),
    with the bilinear gather of the frames at the analytic source map as
    the clamp guide, and 0 where that source is outside the frame."""
    H, W = (int(d) for d in frames.shape[-2:])
    dev = frames.device
    frames = _flip_frames(frames, flipmask)
    out = _affine_czt_passes(frames, M, b, sig_x, sig_y)
    dx = torch.arange(W, dtype=torch.float32, device=dev)[None, None, :]
    dy = torch.arange(H, dtype=torch.float32, device=dev)[None, :, None]
    sx = (M[:, 0, 0, None, None] * dx + M[:, 0, 1, None, None] * dy
          + b[:, 0, None, None])
    sy = (M[:, 1, 0, None, None] * dx + M[:, 1, 1, None, None] * dy
          + b[:, 1, None, None])
    if clamp:
        out = _clamp_to_guide(out, _bilinear_guide(frames, sy, sx))
    ok = (sx >= 0.0) & (sx <= W - 1.0) & (sy >= 0.0) & (sy <= H - 1.0)
    return out * ok[:, None, :, :]


def _czt_args(M, b, H: int, W: int, device, *extra):
    """The per-frame tensors of a chirp-Z rung: M, b, the extra arrays
    (float32), then the four σ pair halves."""
    (sx_hi, sx_lo), (sy_hi, sy_lo) = _czt_sigmas(M, H, W)
    return ([_f32(M, device), _f32(b, device)]
            + [_f32(a, device) for a in extra]
            + [_f32(v, device) for v in (sx_hi, sx_lo, sy_hi, sy_lo)])


def warp_affine_batch(frames: torch.Tensor, aff,
                      clamp: bool = True) -> torch.Tensor:
    """Warp (N, C, H, W) frames by the (M, b, flip) of ``affines_from_Hs``
    with two chirp-Z passes, in chunks of 32 MiB of frames (the transients
    are complex64 at the padded length, about 8× the chunk)."""
    M, b, flip = aff
    H, W = (int(d) for d in frames.shape[-2:])
    dev = frames.device
    Md, bd, a, c, d, e = _czt_args(M, b, H, W, dev)

    def run(fr, Mc, bc, fc, a_, c_, d_, e_):
        return affine_czt_core(fr, Mc, bc, fc, (a_, c_), (d_, e_), clamp)

    return _run_chunked(run, frames, 32 << 20, Md, bd, _flags(flip, dev),
                        a, c, d, e)


def _shift_resample_last(img: torch.Tensor, u: torch.Tensor,
                         D: int) -> torch.Tensor:
    """Lanczos4 resample along the last axis at a per-pixel displacement
    |u| ≤ D: out[..., x] = img(x + u[..., x]) as 2(D+4)+1 shifted slices
    with per-pixel weights renormalized over the window; 0 beyond the
    edges."""
    A = 4
    pad = D + A
    Wl = int(img.shape[-1])
    big = F.pad(img, (pad, pad))
    uc = torch.clamp(u, -float(D), float(D))
    acc = 0.0
    wsum = 0.0
    for i in range(-pad, pad + 1):
        t = uc - i
        at = torch.abs(t)
        pit = _PI32 * t
        w = torch.where(at < 1e-6, 1.0,
                        4.0 * torch.sin(pit) * torch.sin(pit * 0.25)
                        / (pit * pit))
        w = torch.where(at < 4.0, w, 0.0)
        acc = acc + w * big[..., i + pad:i + pad + Wl]
        wsum = wsum + w
    return acc / torch.clamp(wsum, min=1e-20)


def perspective_split_from_Hs(Hs, size, max_D: int = 16,
                              scale_band: float = 0.25,
                              max_shear: float = 0.25):
    """(M, b, flip, K, D) when every H's pull-back factors into an in-band
    affine (the chirp-Z gates of ``affines_from_Hs``) plus a near-identity
    projective remainder q = π(K·d) whose two pass displacements stay
    within D ∈ {2, 4, 8, 16} px (grid-checked, with the row pass's Newton
    conditioning), the horizon out of the frame; else None."""
    Hs = np.asarray(Hs, np.float64)
    if Hs.ndim != 3 or not np.isfinite(Hs).all() \
            or (np.abs(Hs[:, 2, 2]) < 1e-12).any():
        return None
    Hn = Hs / Hs[:, 2:3, 2:3]
    if (np.abs(np.linalg.det(Hn)) < 1e-9).any():
        return None
    Hinv = np.linalg.inv(Hn)
    Hi, Wi = int(size[0]), int(size[1])
    gx = np.linspace(0.0, Wi - 1.0, 33)
    gy = np.linspace(0.0, Hi - 1.0, 33)
    GX, GY = (a.ravel() for a in np.meshgrid(gx, gy))
    pts = np.stack([GX, GY, np.ones_like(GX)], axis=1)
    full = np.einsum("nij,pj->npi", Hinv, pts)
    den = full[..., 2]
    if (np.abs(den) < 1e-6 * np.abs(den).max(axis=1, keepdims=True)).any() \
            or ((den.min(1) * den.max(1)) <= 0.0).any():
        return None
    src = full[..., :2] / den[..., None]
    coef = np.einsum("jp,npk->njk", np.linalg.pinv(pts), src)
    A = coef[:, :2, :].transpose(0, 2, 1)
    t = coef[:, 2, :]
    resid = src - (np.einsum("nij,pj->npi", A, pts[:, :2]) + t[:, None])
    rmax = np.abs(resid).max()
    if not np.isfinite(rmax) or rmax > max_D:
        return None
    fold = _fold_gate_inverse_affine(A, t, size, scale_band, max_shear)
    if fold is None:
        return None
    Mf, bf, flip = fold
    S = np.array([[-1.0, 0.0, Wi - 1.0], [0.0, -1.0, Hi - 1.0],
                  [0.0, 0.0, 1.0]])
    Hf = np.where(flip[:, None, None], np.einsum("ij,njk->nik", S, Hinv),
                  Hinv)
    m00, m01 = Mf[:, 0, 0], Mf[:, 0, 1]
    m10, m11 = Mf[:, 1, 0], Mf[:, 1, 1]
    detf = m00 * m11 - m01 * m10
    Minv = np.stack([np.stack([m11, -m01], -1),
                     np.stack([-m10, m00], -1)], -2) / detf[:, None, None]
    K = np.concatenate(
        [np.einsum("nij,njk->nik",
                   Minv, Hf[:, :2] - bf[:, :, None] * Hf[:, 2:3]),
         Hf[:, 2:3]], axis=1)
    kden = np.einsum("nj,pj->np", K[:, 2], pts)
    qy = np.einsum("nj,pj->np", K[:, 1], pts) / kden
    u_y = qy - GY[None]
    sig = np.broadcast_to(GY[None], qy.shape).copy()
    for _ in range(3):
        dn = K[:, 2, 0:1] * GX[None] + K[:, 2, 1:2] * sig + K[:, 2, 2:3]
        qs = (K[:, 1, 0:1] * GX[None] + K[:, 1, 1:2] * sig
              + K[:, 1, 2:3]) / dn
        dq = (K[:, 1, 1:2] - qs * K[:, 2, 1:2]) / dn
        if (dq < 0.25).any():
            return None
        sig = sig - (qs - GY[None]) / dq
    dn = K[:, 2, 0:1] * GX[None] + K[:, 2, 1:2] * sig + K[:, 2, 2:3]
    hx = (K[:, 0, 0:1] * GX[None] + K[:, 0, 1:2] * sig
          + K[:, 0, 2:3]) / dn
    u_x = hx - GX[None]
    umax = max(np.abs(u_x).max(), np.abs(u_y).max())
    if not np.isfinite(umax) or umax + 1.0 > max_D:
        return None
    D = next((B for B in (2, 4, 8, 16) if umax + 1.0 <= B), None)
    if D is None:
        return None
    return Mf, bf, flip, K, D


def perspective_czt_core(frames: torch.Tensor, M, b, K, flipmask, sig_x,
                         sig_y, D: int, clamp: bool = True) -> torch.Tensor:
    """The affine chirp-Z passes, then the remainder q as a row pass and a
    column pass of bounded lanczos4 shifts (the row map's source rows by
    two Newton steps), the bilinear gather of the frames at the analytic
    source map as the clamp guide, and 0 outside the band where the
    passes' tap windows read the chirp-Z's materialized grid of the
    frame."""
    H, W = (int(d) for d in frames.shape[-2:])
    dev = frames.device
    frames = _flip_frames(frames, flipmask)
    tmp = _affine_czt_passes(frames, M, b, sig_x, sig_y)
    yy = torch.arange(H, dtype=torch.float32, device=dev)[None, :, None]
    xx = torch.arange(W, dtype=torch.float32, device=dev)[None, None, :]

    def kdot(row, xf, yf):
        return (K[:, row, 0, None, None] * xf
                + K[:, row, 1, None, None] * yf
                + K[:, row, 2, None, None])

    sig = yy.expand(K.shape[0], H, W)
    for _ in range(2):
        dn = kdot(2, xx, sig)
        qs = kdot(1, xx, sig) / dn
        dq = (K[:, 1, 1, None, None] - qs * K[:, 2, 1, None, None]) / dn
        sig = sig - (qs - yy) / dq
    u_x = kdot(0, xx, sig) / kdot(2, xx, sig) - xx
    V = _shift_resample_last(tmp, u_x[:, None], D)
    dn0 = kdot(2, xx, yy)
    qx0 = kdot(0, xx, yy) / dn0
    qy0 = kdot(1, xx, yy) / dn0
    out = _shift_resample_last(V.transpose(-1, -2),
                               (qy0 - yy).transpose(-1, -2)[:, None],
                               D).transpose(-1, -2)
    srcx = (M[:, 0, 0, None, None] * qx0 + M[:, 0, 1, None, None] * qy0
            + b[:, 0, None, None])
    srcy = (M[:, 1, 0, None, None] * qx0 + M[:, 1, 1, None, None] * qy0
            + b[:, 1, None, None])
    if clamp:
        out = _clamp_to_guide(out, _bilinear_guide(frames, srcy, srcx))
    A = 4.0
    mqx, mqy = A + 2.0, A
    rsx = (torch.abs(M[:, 0, 0]) * mqx + torch.abs(M[:, 0, 1]) * mqy
           + 0.5)[:, None, None]
    rsy = (torch.abs(M[:, 1, 0]) * mqx + torch.abs(M[:, 1, 1]) * mqy
           + 0.5)[:, None, None]
    ok = ((srcx >= rsx) & (srcx <= W - 1.0 - rsx)
          & (srcy >= rsy) & (srcy <= H - 1.0 - rsy)
          & (qx0 >= mqx) & (qx0 <= W - 1.0 - mqx)
          & (qy0 >= mqy) & (qy0 <= H - 1.0 - mqy))
    return out * ok[:, None, :, :]


def warp_perspective_batch(frames: torch.Tensor, persp,
                           clamp: bool = True) -> torch.Tensor:
    """Warp (N, C, H, W) frames by the (M, b, flip, K, D) of
    ``perspective_split_from_Hs``, in chunks of 24 MiB of frames (the
    shift passes add padded transients to the chirp-Z's)."""
    M, b, flip, K, D = persp
    H, W = (int(d) for d in frames.shape[-2:])
    dev = frames.device
    Md, bd, Kd, a, c, d, e = _czt_args(M, b, H, W, dev, K)

    def run(fr, Mc, bc, Kc, fc, a_, c_, d_, e_):
        return perspective_czt_core(fr, Mc, bc, Kc, fc, (a_, c_), (d_, e_),
                                    int(D), clamp)

    return _run_chunked(run, frames, 24 << 20, Md, bd, Kd,
                        _flags(flip, dev), a, c, d, e)


def ladder_transient_bytes(channels: int, H: int, W: int) -> int:
    """Device bytes the ladder's rungs hold beside their chunk of frames
    and its output at most: twelve complex64 planes at the chirp-Z length
    L ≥ 2W − 1 for one frame, 3 GiB at 4096² (the perspective rung peaked
    at 2.4 GiB there on an H100, the affine at 1.8, the rotation at 0.7:
    chip_smoke.py's warps phase)."""
    L = 1 << int(np.ceil(np.log2(max(2 * max(H, W) - 1, 2))))
    return 12 * 8 * channels * max(H, W) * L
