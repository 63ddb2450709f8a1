"""Warps — counterpart of ``siril_tpu/ops/interp.py``: the general
gather warp (``_cubic_weights``:45, ``_lanczos_weights``:61,
``_gather_plane``:74, ``sample_plane``:86, ``_warp_body``:135,
``warp_homography_batch``:218, ``warp_homography``:238, ``_dilate3``:258)
and the pure-translation warp (constants :26, ``_shift_batch_fn``:365,
``warp_translation_batch``:460, ``translations_from_Hs``:482).

The gather warp (the staged ``register`` and ``seqapplyreg``): for each
output pixel the source coordinate H⁻¹·x, then nearest, bilinear
(area), bicubic (a = −0.75) or lanczos4 taps gathered and summed in
float32, out-of-frame taps reading 0; rows are warped in blocks so that
a 4096² lanczos4 warp keeps each tap's index tensor to one block.  The
clamp substitutes the bilinear guide where the result undershoots
0.98·guide, dilated 3×3 with wrap-around (opencv.cpp:264-276).

The integer part of a shift is a padded slice, the fractional part a
separable 8-tap lanczos4 (4-tap cubic, 2-tap bilinear) filter written as
explicit weighted sums of shifted slices, in float32 — no convolution, so
cuDNN's TF32 does not apply.  The ringing clamp (opencv.cpp:264-276)
substitutes a bilinear guide where the result undershoots 0.98·guide,
dilated 3×3.  The FFT warps of the fused path (rotation shear, affine
chirp-Z, perspective split) are not ported yet (ROADMAP §1.2).
"""

from __future__ import annotations

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

_TAPS = {INTERP_LANCZOS4: 4, INTERP_BICUBIC: 2, INTERP_BILINEAR: 1}


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
    A = _TAPS[method]
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
    if method not in _TAPS:
        raise NotImplementedError(
            f"interpolation {method} is not ported for the translation "
            "warp (ROADMAP §1, the warp ladder)")
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
               out_w: int, method: int, clamp: bool) -> torch.Tensor:
    """(C, H, W) planes and one float32 H⁻¹ → (C, out_h, out_w)."""
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


def warp_homography_batch(frames: torch.Tensor, Hs, out_shape,
                          method: int = INTERP_LANCZOS4,
                          clamp: bool = True) -> torch.Tensor:
    """Warp an (N, C, H, W) batch by per-frame homographies (N, 3, 3)."""
    Hs = np.asarray(Hs, np.float64)
    return torch.stack([warp_homography(frames[i], Hs[i], out_shape,
                                        method, clamp)
                        for i in range(frames.shape[0])])
