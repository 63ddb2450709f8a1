"""Star resynthesis and star suppression — counterpart of
``siril_tpu/ops/synthstar.py`` (``resynthesize_stars``:16; reference
``src/filters/synthstar.c``) and of ``ssr``'s star mask
(``siril_tpu/cli/commands2.py:575``, command.c process_ssr).

``synthstar`` paints a Gaussian from each detected star's fit over its
footprint with ``max``; on an RGB image the other channels keep the
star's colour ratio, read from the pixels at its centre.  The JAX package
paints the stars one after another, and a star reads ``region.min()`` and
the centre pixels from data that earlier stars may have painted.  Here
they are painted in waves on the device: a star joins the first wave
after every earlier star whose box overlaps its own, so the boxes of one
wave are disjoint, overlapping stars keep the JAX package's order, and
the result is the same.  Detection (``detect_stars`` on the device) and
painting are separate functions, so that a test can paint one star list
in both packages.

``ssr`` sets the pixels within max(2·FWHM, 4) px of each star to
median − factor·bgnoise; the disc of each star is tested only inside its
bounding box (the JAX package tests every pixel of the frame once per
star), which gives the same mask.
"""

from __future__ import annotations

import math
from typing import List, Sequence

import numpy as np
import torch

from siril_tpu_torch.core.image import SirilImage
from siril_tpu_torch.device import DeviceLike, resolve_device


def _box(s, H: int, W: int):
    r = int(3.0 * max(s.fwhmx, s.fwhmy)) + 2
    return (max(int(s.y0) - r, 0), min(int(s.y0) + r + 1, H),
            max(int(s.x0) - r, 0), min(int(s.x0) + r + 1, W))


def paint_waves(stars: Sequence, H: int, W: int) -> List[List[int]]:
    """Indices of the stars with a non-empty box, in waves: a star goes
    one wave after the latest earlier star whose box overlaps its own."""
    boxes = [_box(s, H, W) for s in stars]
    keep = [i for i, (y0, y1, x0, x1) in enumerate(boxes)
            if x1 > x0 and y1 > y0]
    if not keep:
        return []
    b = np.array([boxes[i] for i in keep], np.int64)
    wave = np.zeros(len(keep), np.int64)
    for j in range(1, len(keep)):
        y0, y1, x0, x1 = b[j]
        over = ((b[:j, 0] < y1) & (y0 < b[:j, 1])
                & (b[:j, 2] < x1) & (x0 < b[:j, 3]))
        if over.any():
            wave[j] = wave[:j][over].max() + 1
    return [[keep[j] for j in np.nonzero(wave == k)[0]]
            for k in range(int(wave.max()) + 1)]


def paint_stars(data: torch.Tensor, stars: Sequence, lay_i: int
                ) -> torch.Tensor:
    """Paint the stars' models into a float32 (C, H, W) tensor, in place,
    as ``resynthesize_stars``:26-50 does star after star; returns it."""
    C, H, W = data.shape
    dev = data.device
    for wave in paint_waves(stars, H, W):
        sel = [stars[i] for i in wave]
        bx = [_box(s, H, W) for s in sel]
        K = len(sel)
        bh = max(y1 - y0 for y0, y1, _, _ in bx)
        bw = max(x1 - x0 for _, _, x0, x1 in bx)
        y0 = torch.tensor([b[0] for b in bx], device=dev)
        x0 = torch.tensor([b[2] for b in bx], device=dev)
        hh = torch.tensor([b[1] - b[0] for b in bx], device=dev)
        ww = torch.tensor([b[3] - b[2] for b in bx], device=dev)
        iy = torch.arange(bh, device=dev)
        ix = torch.arange(bw, device=dev)
        inside = (iy[None, :, None] < hh[:, None, None]) & \
            (ix[None, None, :] < ww[:, None, None])
        yy = (y0[:, None, None] + iy[None, :, None]).expand(K, bh, bw)
        xx = (x0[:, None, None] + ix[None, None, :]).expand(K, bh, bw)
        pix = torch.where(inside, yy * W + xx, 0)

        def col(vals):
            return torch.tensor(vals, dtype=torch.float64,
                                device=dev)[:, None, None]

        # the model in float64 (numpy's order of operations)
        sub_x = (xx.double() + 0.5) - col([s.x0 for s in sel])
        sub_y = (yy.double() + 0.5) - col([s.y0 for s in sel])
        th = np.radians([s.angle for s in sel])
        ca, sa = col(np.cos(th)), col(np.sin(th))
        u = ca * sub_x - sa * sub_y
        v = sa * sub_x + ca * sub_y
        sx = col([max(s.sx, 0.5) for s in sel])
        sy = col([max(s.sy, 0.5) for s in sel])
        model = col([s.A for s in sel]) * torch.exp(
            -(u * u / sx + v * v / sy))
        centre = torch.tensor([int(s.y0) * W + int(s.x0) for s in sel],
                              device=dev)
        flat = data.reshape(C, -1)
        for c in range(C):
            region = flat[c][pix]
            if C == 3 and c != lay_i:
                peak_orig = flat[lay_i][centre]
                peak_c = flat[c][centre]
                scale = torch.where(peak_orig > 1e-6, peak_c / peak_orig,
                                    torch.ones_like(peak_c)).double()
            else:
                scale = torch.ones(K, dtype=torch.float64, device=dev)
            if c == lay_i:
                base = col([s.B for s in sel])
            else:
                base = torch.where(inside, region, math.inf).amin(
                    dim=(1, 2)).double()[:, None, None]
            synth = (base + model * scale[:, None, None]).float()
            painted = torch.maximum(region, synth)
            flat[c][pix[inside]] = painted[inside]
    return data


def detect_for_synth(img: SirilImage, layer: int = 0,
                     device: DeviceLike = None) -> list:
    """The stars ``resynthesize_stars`` rebuilds: the star finder's, at
    its defaults, on layer ``layer``."""
    from siril_tpu_torch.registration.starfinder import detect_stars

    lay_i = min(layer, img.nchans - 1)
    x = torch.from_numpy(np.ascontiguousarray(img.host()[lay_i])).to(
        resolve_device(device))
    return detect_stars(x)


def resynthesize_stars(img: SirilImage, only_clipped: bool = False,
                       layer: int = 0, device: DeviceLike = None,
                       stars=None) -> SirilImage:
    """``synthstar`` (``resynthesize_stars``:16): rebuild each star from
    its PSF fit (only the saturated ones with ``only_clipped``), on
    ``device``; ``stars`` replaces the detection."""
    dev = resolve_device(device)
    lay_i = min(layer, img.nchans - 1)
    if stars is None:
        stars = detect_for_synth(img, layer, dev)
    if only_clipped:
        stars = [s for s in stars if s.has_saturated]
    data = torch.from_numpy(img.host().copy()).to(dev)
    paint_stars(data, stars, lay_i)
    out = img.copy(data=np.ascontiguousarray(
        torch.clamp(data, 0.0, 1.0).cpu().numpy()))
    out.log_history("Star resynthesis" +
                    (" (unclip)" if only_clipped else ""))
    return out


def star_discs(stars: Sequence, H: int, W: int,
               device: torch.device) -> torch.Tensor:
    """(H, W) bool: the pixels (x, y) with (x − x0)² + (y − y0)² ≤ r²,
    r = max(2·FWHMx, 4), of any star, in float64 as numpy does, each star
    tested inside its bounding box only."""
    mask = torch.zeros(H * W, dtype=torch.bool, device=device)
    if not len(stars):
        return mask.reshape(H, W)
    cx = np.array([s.x0 for s in stars], np.float64)
    cy = np.array([s.y0 for s in stars], np.float64)
    r = np.maximum(2.0 * np.array([s.fwhmx for s in stars], np.float64),
                   4.0)
    xlo = np.clip(np.floor(cx - r).astype(np.int64) - 1, 0, W)
    xhi = np.clip(np.ceil(cx + r).astype(np.int64) + 2, 0, W)
    ylo = np.clip(np.floor(cy - r).astype(np.int64) - 1, 0, H)
    yhi = np.clip(np.ceil(cy + r).astype(np.int64) + 2, 0, H)
    side = np.maximum(xhi - xlo, yhi - ylo)
    # stars by box size, so that one big star does not pad them all
    order = np.argsort(side, kind="stable")
    for k0 in range(0, len(order), 1024):
        sel = order[k0:k0 + 1024]
        b = int(max(side[sel].max(), 1))
        t = torch.arange(b, device=device)

        def col(a, dtype=torch.float64):
            return torch.as_tensor(a[sel], dtype=dtype,
                                   device=device)[:, None, None]

        yy = col(ylo, torch.int64) + t[None, :, None]
        xx = col(xlo, torch.int64) + t[None, None, :]
        ok = (yy < col(yhi, torch.int64)) & (xx < col(xhi, torch.int64))
        rr = col(r)
        hit = ((xx.double() - col(cx)) ** 2 + (yy.double() - col(cy)) ** 2
               <= rr * rr) & ok
        idx = (yy * W + xx).expand(hit.shape)[hit]
        mask[idx] = True
    return mask.reshape(H, W)
