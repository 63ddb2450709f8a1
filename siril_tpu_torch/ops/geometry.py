"""Geometry — counterpart of ``siril_tpu/ops/geometry.py``: ``crop``
(:16), ``mirrorx`` (:31), ``mirrory`` (:37), ``rotate`` (:43), ``binxy``
(:84) and ``resample`` (:102), each on ``device`` (CUDA unless "cpu").

``rotate`` turns multiples of 90° by exact transposes and any other angle
through the gather warp (``ops/interp.warp_homography``) about the image
centre, on the reference's canvas (``crop_to_fit``: the input's size;
else the turned image's bounding box, ``-nocrop``).  ``binxy`` adds each
factor × factor block in the JAX package's numpy order (its rows one
after the other, each row summed as numpy's pairwise reduction sums a
contiguous run), so that the sum and the mean are bit-equal to it.  As
in the JAX package, only ``crop`` moves the plate solution.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from siril_tpu_torch.core.image import SirilImage
from siril_tpu_torch.device import DeviceLike
from siril_tpu_torch.ops.interp import (
    INTERP_LANCZOS4,
    resize,
    warp_homography,
)
from siril_tpu_torch.ops.stretch import upload


def _result(img: SirilImage, out: torch.Tensor, msg: str) -> SirilImage:
    res = img.copy(data=np.ascontiguousarray(out.cpu().numpy()))
    res.log_history(msg)
    return res


def crop(img: SirilImage, x: int, y: int, w: int, h: int,
         device: DeviceLike = None) -> SirilImage:
    """The rectangle (x, y, w, h) in top-down coordinates, clamped to the
    image; the WCS shifted with it (geometry.c crop)."""
    C, H, W = img.data.shape
    x = max(0, min(x, W - 1))
    y = max(0, min(y, H - 1))
    w = max(1, min(w, W - x))
    h = max(1, min(h, H - y))
    d = upload(img, device)
    out = _result(img, d[:, y:y + h, x:x + w],
                  f"Crop (x={x}, y={y}, w={w}, h={h})")
    if out.wcs is not None:
        out.wcs = out.wcs.shifted(-x, -y) if hasattr(out.wcs, "shifted") \
            else None
    return out


def mirrorx(img: SirilImage, device: DeviceLike = None) -> SirilImage:
    """Rows upside down."""
    return _result(img, torch.flip(upload(img, device), (1,)), "Mirror X")


def mirrory(img: SirilImage, device: DeviceLike = None) -> SirilImage:
    """Columns right to left."""
    return _result(img, torch.flip(upload(img, device), (2,)), "Mirror Y")


def rotate_tensor(d: torch.Tensor, angle_deg: float,
                  method: int = INTERP_LANCZOS4, crop_to_fit: bool = False,
                  clamp: bool = True) -> torch.Tensor:
    """A (C, H, W) tensor turned by ``angle_deg``: exact transposes at
    90°, 180° and 270°, else the gather warp about the image centre
    (cvRotateImage)."""
    a = angle_deg % 360.0
    if a == 180.0:
        return torch.flip(d, (1, 2))
    if a in (90.0, 270.0):
        return torch.rot90(d, k=1 if a == 90.0 else 3, dims=(1, 2))
    C, H, W = d.shape
    th = math.radians(a)
    c, s = math.cos(th), math.sin(th)
    cx, cy = (W - 1) / 2.0, (H - 1) / 2.0
    if crop_to_fit:
        out_w, out_h = W, H
        ocx, ocy = cx, cy
    else:
        out_w = int(round(abs(W * c) + abs(H * s)))
        out_h = int(round(abs(W * s) + abs(H * c)))
        ocx, ocy = (out_w - 1) / 2.0, (out_h - 1) / 2.0
    # source → target: translate(−centre) · turn · translate(+centre')
    T1 = np.array([[1, 0, -cx], [0, 1, -cy], [0, 0, 1]])
    R = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
    T2 = np.array([[1, 0, ocx], [0, 1, ocy], [0, 0, 1]])
    return warp_homography(d, T2 @ R @ T1, (out_h, out_w), method, clamp)


def rotate(img: SirilImage, angle_deg: float,
           method: int = INTERP_LANCZOS4, crop_to_fit: bool = False,
           clamp: bool = True, device: DeviceLike = None) -> SirilImage:
    """``rotate`` (``rotate_tensor``); a turn by 0 is a copy."""
    a = angle_deg % 360.0
    if a == 0.0:
        return img.copy()
    out = rotate_tensor(upload(img, device), angle_deg, method,
                        crop_to_fit, clamp)
    if a in (90.0, 180.0, 270.0):
        return _result(img, out, f"Rotation ({a:.1f} deg)")
    return _result(img, out, f"Rotation ({angle_deg:.2f} deg)")


def _pairwise(vals: list) -> torch.Tensor:
    """Σ vals in numpy's pairwise order for a contiguous run (eight
    running sums from 8 terms on, halves past 128)."""
    n = len(vals)
    if n < 8:
        acc = vals[0]
        for v in vals[1:]:
            acc = acc + v
        return acc
    if n > 128:
        half = n // 2
        half -= half % 8
        return _pairwise(vals[:half]) + _pairwise(vals[half:])
    r = list(vals[:8])
    i = 8
    while i < n - n % 8:
        for j in range(8):
            r[j] = r[j] + vals[i + j]
        i += 8
    acc = ((r[0] + r[1]) + (r[2] + r[3])) + ((r[4] + r[5]) + (r[6] + r[7]))
    for k in range(i, n):
        acc = acc + vals[k]
    return acc


def bin_tensor(d: torch.Tensor, factor: int,
               mean: bool = True) -> torch.Tensor:
    """Each factor × factor block of a (C, H, W) tensor: its mean, or its
    sum clipped to [0, 1], added in numpy's order."""
    C, H, W = d.shape
    f = int(factor)
    h2, w2 = H // f, W // f
    q = d[:, :h2 * f, :w2 * f].reshape(C, h2, f, w2, f)
    acc = None
    for a in range(f):
        row = _pairwise([q[:, :, a, :, b] for b in range(f)])
        acc = row if acc is None else acc + row
    if mean:
        return acc / torch.tensor(float(f * f), dtype=torch.float32,
                                  device=acc.device)
    return torch.clamp(acc, 0.0, 1.0)


def binxy(img: SirilImage, factor: int, mean: bool = True,
          device: DeviceLike = None) -> SirilImage:
    """Binning × ``factor`` (geometry.c binxy, ``bin_tensor``)."""
    f = int(factor)
    out = _result(img, bin_tensor(upload(img, device), f, mean),
                  f"Binning {f}x{f} ({'mean' if mean else 'sum'})")
    # the port keeps XBINNING / YBINNING among the header's other cards
    extra = out.keywords.extra
    for key in ("XBINNING", "YBINNING"):
        extra[key] = int(extra.get(key, 1) or 1) * f
    return out


def resample(img: SirilImage, to_w: int, to_h: int,
             method: int = INTERP_LANCZOS4, clamp: bool = True,
             device: DeviceLike = None) -> SirilImage:
    """``img`` scaled to ``to_w`` × ``to_h`` on ``device`` (CUDA unless
    "cpu")."""
    x = upload(img, device)
    return _result(img, resize(x, to_w, to_h, method, clamp),
                   f"Resample to {to_w}x{to_h}")
