"""Drizzle — counterpart of ``siril_tpu/ops/drizzle.py`` (kernel ids
:31-40, ``DrizzleArgs``:43, ``_frame_core``:51, ``_taps_for``:195, the
finalize step :213, ``DrizzleAccumulator``:227, ``drizzle_sequence``:404;
reference ``src/drizzle/``, the STScI cdrizzle port).

Drizzle as a gather: every output pixel maps back through the inverse
transform to input coordinates and takes the shrunken input pixels (side
``pixfrac``) its footprint overlaps, with per-kernel tap weights; the
weight map accumulates beside the flux.  Bayer drizzle sends each CFA
site to its colour's plane.  Eager torch on the frame's device; the
accumulator stays there.

Float32 throughout, in the JAX package's order: at scale 2 half of the
samples land exactly on .5, where the point kernel's strict ``|sx − cx|
< 0.5`` and ``round`` (half to even) decide whole taps.  XLA:CPU fuses
each tap's ``acc + w·v`` and the Gaussian's ``dx² + dy²`` into one
rounding (``ops.rejection.fma``), and the coordinate sums only inside the
chunk path's frame loop (``frame_core``'s ``fused``).
"""

from __future__ import annotations

import concurrent.futures as cf
import logging
import time
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from siril_tpu_torch.core.image import SirilImage
from siril_tpu_torch.device import DeviceLike, resolve_device, synchronize
from siril_tpu_torch.ops.rejection import fma

_log = logging.getLogger(__name__)

KERNEL_SQUARE = 0
KERNEL_TURBO = 1
KERNEL_POINT = 2
KERNEL_GAUSSIAN = 3
KERNEL_LANCZOS2 = 4
KERNEL_LANCZOS3 = 5

KERNEL_NAMES = {"square": KERNEL_SQUARE, "turbo": KERNEL_TURBO,
                "point": KERNEL_POINT, "gaussian": KERNEL_GAUSSIAN,
                "lanczos2": KERNEL_LANCZOS2, "lanczos3": KERNEL_LANCZOS3}

_F32 = np.float32


@dataclass
class DrizzleArgs:
    scale: float = 2.0
    pixfrac: float = 1.0
    kernel: int = KERNEL_SQUARE
    use_bayer: bool = False            # CFA-direct drizzle
    pattern: str = "RGGB"


def _taps_for(kernel: int, pixfrac: float, inv_scale: float) -> int:
    """Side of the tap square around round(sx): the reach of each
    kernel's weight (square/turbo: the 1-D overlap of [sx ± inv_scale/2]
    with [c ± pixfrac/2] vanishes past (pixfrac + inv_scale)/2)."""
    if kernel == KERNEL_POINT:
        return 3
    if kernel == KERNEL_LANCZOS2:
        return 5
    if kernel == KERNEL_LANCZOS3:
        return 7
    if kernel == KERNEL_GAUSSIAN:
        return 2 * int(np.ceil(3.0 * (0.42466 * pixfrac) + 0.5)) + 1
    reach = 0.5 * (pixfrac + inv_scale)
    return 2 * int(np.floor(reach + 0.5)) + 1


def _lanczos(t: torch.Tensor, a: float) -> torch.Tensor:
    pt = t * _F32(np.pi)
    s = torch.where(t.abs() < 1e-7, 1.0,
                    _F32(a) * torch.sin(pt) * torch.sin(pt / _F32(a))
                    / (pt * pt))
    return torch.where(t.abs() < _F32(a), s, 0.0)


def frame_core(frame: torch.Tensor, wplane, pid: Optional[torch.Tensor],
               Hinv: np.ndarray, pixfrac: float, inv_scale: float,
               out_h: int, out_w: int, kernel: int, taps: int,
               nplanes: int = 1, y_off: int = 0, fused: bool = False
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One frame's (nplanes, out_h, out_w) flux and weight contributions
    to the output rows [y_off, y_off + out_h) (``_frame_core``).

    ``frame`` (H, W) float32; ``wplane`` the input weights, an (H, W)
    tensor or a float32 scalar; ``pid`` (H, W) int plane id of each input
    pixel (Bayer: 0 R, 1 G, 2 B; None for one plane); ``Hinv`` (3, 3)
    float32 maps output pixel coordinates to input ones.  ``fused``: the
    coordinate sums a·x + b·y + c take a·x + b·y with one rounding, as
    XLA:CPU compiles them inside the JAX package's frame loop (a chunk of
    two frames or more); its per-frame program and a one-frame chunk
    round each product."""
    dev = frame.device
    H_in, W_in = frame.shape
    h = [float(v) for v in np.asarray(Hinv, _F32).ravel()]
    xf = torch.arange(out_w, device=dev, dtype=torch.int32).float()[None, :]
    yf = (torch.arange(out_h, device=dev, dtype=torch.int32)
          + y_off).float()[:, None]
    shape = (out_h, out_w)
    xf, yf = xf.expand(shape), yf.expand(shape)

    def row(a, b, c):
        return (fma(a, xf, b * yf) if fused else a * xf + b * yf) + c

    d = row(h[6], h[7], h[8])
    sx = row(h[0], h[1], h[2]) / d
    sy = row(h[3], h[4], h[5]) / d
    del d
    half = _F32(0.5) * _F32(inv_scale)
    pf = _F32(pixfrac)
    pf_half = _F32(0.5) * pf
    rx = torch.round(sx).to(torch.int32)
    ry = torch.round(sy).to(torch.int32)
    flat = frame.reshape(-1)
    wflat = wplane.reshape(-1) if isinstance(wplane, torch.Tensor) else None
    pflat = pid.reshape(-1) if pid is not None else None
    acc = [torch.zeros(shape, dtype=torch.float32, device=dev)
           for _ in range(nplanes)]
    wht = [torch.zeros(shape, dtype=torch.float32, device=dev)
           for _ in range(nplanes)]
    r = taps // 2
    for dy in range(-r, r + 1):
        iy = ry + dy
        iny = (iy >= 0) & (iy < H_in)
        cy = iy.float()
        rowi = iy.clamp(0, H_in - 1).long() * W_in
        del iy
        for dx in range(-r, r + 1):
            ix = rx + dx
            inb = iny & (ix >= 0) & (ix < W_in)
            cx = ix.float()
            idx = rowi + ix.clamp(0, W_in - 1)
            del ix
            v = torch.take(flat, idx)
            wv = torch.take(wflat, idx) if wflat is not None else wplane
            if kernel in (KERNEL_SQUARE, KERNEL_TURBO):
                ox = torch.clamp_min(
                    torch.minimum(sx + half, cx + pf_half)
                    - torch.maximum(sx - half, cx - pf_half), 0.0)
                oy = torch.clamp_min(
                    torch.minimum(sy + half, cy + pf_half)
                    - torch.maximum(sy - half, cy - pf_half), 0.0)
                w = ox * oy / (pf * pf)
                del ox, oy
            elif kernel == KERNEL_POINT:
                w = (((sx - cx).abs() < 0.5) & ((sy - cy).abs() < 0.5)
                     ).float()
            elif kernel == KERNEL_GAUSSIAN:
                sig = _F32(0.42466) * pf + _F32(1e-6)
                ex, ey = sx - cx, sy - cy
                d2 = fma(ex, ex, ey * ey)
                w = torch.exp(_F32(-0.5) * d2 / (sig * sig))
            else:
                a = 2.0 if kernel == KERNEL_LANCZOS2 else 3.0
                w = _lanczos(sx - cx, a) * _lanczos(sy - cy, a)
            w = torch.where(inb, w * wv, 0.0)
            del inb, cx
            if nplanes == 1:
                acc[0] = fma(w, v, acc[0])
                wht[0] = wht[0] + w
            else:
                p = torch.take(pflat, idx)
                for c in range(nplanes):
                    wc = torch.where(p == c, w, 0.0)
                    acc[c] = fma(wc, v, acc[c])
                    wht[c] = wht[c] + wc
            del idx
        del rowi, cy, iny
    return torch.stack(acc), torch.stack(wht)


def finalize_planes(acc: torch.Tensor, wht: torch.Tensor, nframes: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out, weight map): flux over weight clamped to [0, 1] where the
    weight is above 1e-9, else 0; the weight over the frame count."""
    inv_n = _F32(1.0 / max(nframes, 1))
    out = torch.where(wht > 1e-9, acc / torch.clamp_min(wht, 1e-9), 0.0)
    return out.clamp(0.0, 1.0), wht * inv_n


def cfa_plane_ids(pattern: str, h: int, w: int, device) -> torch.Tensor:
    """(h, w) int32 plane of each CFA site: 0 R, 1 G, 2 B."""
    from siril_tpu_torch.ops.demosaic import _cfa_masks

    _, gm, bm = _cfa_masks(pattern, h, w, device=device)
    return gm.to(torch.int32) + 2 * bm.to(torch.int32)


class DrizzleAccumulator:
    """Flux and weight planes of a drizzle, (C, H, W) float32 each, on
    ``device``.  Frames are drizzled in row bands of at most
    ``BAND_ELEMS`` output elements (C·rows·W), which bounds the
    temporaries a tap allocates; the result does not depend on the
    bands."""

    BAND_ELEMS = 64 << 20

    def __init__(self, out_shape: Tuple[int, int, int],
                 args: Optional[DrizzleArgs] = None,
                 device: DeviceLike = None):
        self.args = args or DrizzleArgs()
        self.device = resolve_device(device)
        self.C, self.H, self.W = out_shape
        n_bands = max(1, -(-(self.C * self.H * self.W) // self.BAND_ELEMS))
        band_h = -(-self.H // n_bands)
        self.bands = [(y0, min(band_h, self.H - y0))
                      for y0 in range(0, self.H, band_h)]
        self.acc = torch.zeros(out_shape, dtype=torch.float32,
                               device=self.device)
        self.wht = torch.zeros_like(self.acc)
        self.nframes = 0

    def _drizzle(self, planes, wplane, pid, Hinv, channels,
                 fused: bool = False) -> None:
        """Drizzle ``planes`` ((L, H, W) on the device) into the output
        planes ``channels`` (one per input plane, or three for a CFA
        mosaic when ``pid`` is given), band by band."""
        a = self.args
        inv_scale = 1.0 / a.scale
        taps = _taps_for(a.kernel, a.pixfrac, inv_scale)
        nplanes = 3 if pid is not None else 1
        for y0, h in self.bands:
            band = slice(y0, y0 + h)
            for k, c in enumerate(channels):
                da, dw = frame_core(planes[k], wplane, pid, Hinv,
                                    a.pixfrac, inv_scale, h, self.W,
                                    a.kernel, taps, nplanes, y0, fused)
                sel = slice(0, 3) if pid is not None else slice(c, c + 1)
                self.acc[sel, band] += da
                self.wht[sel, band] += dw

    def add_frame(self, img: SirilImage, H_reg: np.ndarray,
                  weight: float = 1.0, weight_plane=None) -> None:
        """One frame; ``H_reg`` maps frame coordinates to the reference's
        (the sequence's registration).  ``weight_plane``: per-pixel input
        weights (the master flat, cdrizzle's weight map)."""
        a = self.args
        S = np.array([[a.scale, 0, 0], [0, a.scale, 0], [0, 0, 1.0]])
        # float64 inverse, then float32 (add_frame's rule)
        Hinv = np.linalg.inv(S @ H_reg).astype(_F32)
        data = img.host()
        w = np.full(data.shape[1:], weight, _F32)
        if weight_plane is not None:
            w = w * np.asarray(weight_plane, _F32)
        dev = self.device
        w_d = torch.from_numpy(w).to(dev)
        if a.use_bayer and img.is_cfa():
            from siril_tpu_torch.ops.demosaic import effective_pattern

            pat = effective_pattern(img.keywords.bayer_pattern or a.pattern,
                                    img.keywords.bayer_xoffset,
                                    img.keywords.bayer_yoffset)
            pid = cfa_plane_ids(pat, data.shape[1], data.shape[2], dev)
            self._drizzle(torch.from_numpy(data[:1]).to(dev), w_d, pid,
                          Hinv, [0])
        else:
            n = min(self.C, data.shape[0])
            self._drizzle(torch.from_numpy(data[:n]).to(dev), w_d, None,
                          Hinv, list(range(n)))
        self.nframes += 1

    def add_frames(self, frames: torch.Tensor, Hs: np.ndarray,
                   weights=None, weight_plane=None,
                   pattern: Optional[str] = None) -> None:
        """A chunk of frames: ``frames`` (K, L, H, W) int16 (the u16 FITS
        layout, decoded here) or float32, on the device; ``Hs`` (K, 3, 3)
        frame → reference transforms; ``pattern`` the effective Bayer
        pattern of a CFA chunk (three output planes)."""
        a = self.args
        K, L = frames.shape[:2]
        S = np.array([[a.scale, 0, 0], [0, a.scale, 0], [0, 0, 1.0]],
                     _F32)
        # S in float32, each product's inverse in float64, then float32
        # (add_frames' rule)
        Hinvs = [np.linalg.inv(S @ Hs[k]).astype(_F32) for k in range(K)]
        wts = np.ones(K, _F32) if weights is None \
            else np.asarray(weights, _F32)
        dev = self.device
        wplane = torch.from_numpy(np.asarray(weight_plane, _F32)).to(dev) \
            if weight_plane is not None else None
        pid = cfa_plane_ids(pattern, frames.shape[2], frames.shape[3], dev) \
            if pattern is not None else None
        for k in range(K):
            f = frames[k]
            if f.dtype == torch.int16:
                f = (f.float() + 32768.0) * _F32(1.0 / 65535.0)
            wk = wplane * wts[k] if wplane is not None else wts[k]
            self._drizzle(f, wk, pid, Hinvs[k],
                          [0] if pid is not None else list(range(L)),
                          fused=K > 1)
        self.nframes += K

    def finalize(self, want_weight: bool = True
                 ) -> Tuple[SirilImage, Optional[SirilImage]]:
        out, wmap = finalize_planes(self.acc, self.wht, self.nframes)
        img = SirilImage(data=out.cpu().numpy())
        img.log_history(f"Drizzle stack x{self.args.scale} (pixfrac "
                        f"{self.args.pixfrac}, {self.nframes} frames)")
        wimg = SirilImage(data=wmap.cpu().numpy()) if want_weight else None
        return img, wimg


def drizzle_sequence(seq, args: Optional[DrizzleArgs] = None,
                     reglayer: int = 0, frame_chunk: int = 8,
                     device: DeviceLike = None,
                     stages: Optional[dict] = None):
    """Drizzle-stack the selected, registered frames of ``seq`` on
    ``device`` (CUDA unless "cpu") without writing drizzled frames: raw
    chunks (u16 where the FITS allows) are read one chunk ahead, uploaded
    and accumulated.  ``stages`` gets read, upload, drizzle and fetch
    seconds.  Returns (image, weight map)."""
    from siril_tpu_torch.core.sequence import raw_chunk_reader
    from siril_tpu_torch.ops.demosaic import effective_pattern

    dev = resolve_device(device)
    args = args or DrizzleArgs()
    stages = {} if stages is None else stages
    reg = seq.reg(reglayer)
    sel = [int(i) for i in seq.selected_indices() if reg.valid[i]]
    if not sel:
        raise ValueError(
            "no selected frames with registration data to drizzle")
    first = seq.read_frame(sel[0])
    pattern = None
    if args.use_bayer and first.is_cfa():
        pattern = effective_pattern(
            first.keywords.bayer_pattern or args.pattern,
            first.keywords.bayer_xoffset, first.keywords.bayer_yoffset)
    C = 3 if pattern is not None else first.nchans
    L, H_in, W_in = first.nchans, first.height, first.width
    acc = DrizzleAccumulator(
        (C, int(seq.ry * args.scale), int(seq.rx * args.scale)), args, dev)
    read_chunk, close = raw_chunk_reader(seq, np.asarray(sel), L, H_in, W_in)

    def add(name, t):
        stages[name] = stages.get(name, 0.0) + time.perf_counter() - t

    starts = list(range(0, len(sel), frame_chunk))
    pool = cf.ThreadPoolExecutor(max_workers=1)
    try:
        pending = pool.submit(read_chunk, 0, min(frame_chunk, len(sel)))
        for si, start in enumerate(starts):
            t = time.perf_counter()
            chunk = pending.result()
            add("read", t)
            if si + 1 < len(starts):
                s2 = starts[si + 1]
                pending = pool.submit(read_chunk, s2,
                                      min(frame_chunk, len(sel) - s2))
            t = time.perf_counter()
            frames = torch.from_numpy(chunk).to(dev)
            synchronize(dev)
            add("upload", t)
            t = time.perf_counter()
            Hs = np.stack([reg.H[i] for i in sel[start:start + len(chunk)]])
            acc.add_frames(frames, Hs, pattern=pattern)
            del frames
            synchronize(dev)
            add("drizzle", t)
    finally:
        pool.shutdown(wait=True)
        close()
    t = time.perf_counter()
    out, wmap = acc.finalize()
    add("fetch", t)
    _log.info("Drizzle: %d frames → %dx%d", acc.nframes, out.width,
              out.height)
    return out, wmap
