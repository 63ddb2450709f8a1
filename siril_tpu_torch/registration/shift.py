"""Translation-only registration — counterpart of
``siril_tpu/registration/shift.py`` (``_phasecorr_peak_fn``:27,
``phase_correlate_device``:60, ``decode_phasecorr_peaks``:67,
``phase_correlate``:80, ``_parabola``:96, ``register_shift_dft``:112,
``register_comet``:153, ``_template_fn``:188, ``template_match``:204;
reference ``src/registration/shift_methods.c``, ``kombat/``, ``comet.c``).

DFT phase correlation: the cross power spectrum ``R·conj(F)`` over its
modulus (complex64, ``torch.fft``'s "backward" norm as ``jnp.fft``'s), its
inverse, and the peak — all on the device, so that only the packed (N, 7)
rows come back: the peak, the value there and its four wrapped
neighbours.  The parabola and the wrap to ±H/2 stay on the host in
float64, as numpy computes them.  ``torch.argmax`` takes the first of
equal maxima, as ``jnp.argmax`` does.
"""

from __future__ import annotations

import datetime
import logging
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from siril_tpu_torch.core.sequence import Sequence
from siril_tpu_torch.device import DeviceLike, resolve_device

_log = logging.getLogger(__name__)


def phase_correlate_device(ref: torch.Tensor,
                           frames: torch.Tensor) -> torch.Tensor:
    """Packed (N, 7) float32 peaks of the phase correlation of (N, H, W)
    ``frames`` against the (H, W) ``ref``, on their device: (py, px, the
    value, its up, down, left and right wrapped neighbours)."""
    H, W = (int(d) for d in ref.shape[-2:])
    R = torch.fft.rfft2(ref.float())
    F = torch.fft.rfft2(frames.float())
    cross = R[None] * torch.conj(F)
    cross = cross / torch.clamp(cross.abs(), min=1e-12)
    corr = torch.fft.irfft2(cross, s=(H, W))
    am = torch.argmax(corr.reshape(corr.shape[0], -1), dim=1)
    py, px = am // W, am % W
    idx = torch.arange(corr.shape[0], device=corr.device)

    def at(dy, dx):
        return corr[idx, (py + dy) % H, (px + dx) % W]

    return torch.stack([py.float(), px.float(), at(0, 0), at(-1, 0),
                        at(1, 0), at(0, -1), at(0, 1)], dim=-1)


def _parabola(cm, c0, cp):
    """Vectorized sub-pixel parabola refinement."""
    denom = cm - 2.0 * c0 + cp
    with np.errstate(divide="ignore", invalid="ignore"):
        off = np.clip(0.5 * (cm - cp) / denom, -1.0, 1.0)
    return np.where(np.abs(denom) < 1e-12, 0.0, off)


def decode_phasecorr_peaks(packed, H: int, W: int,
                           subpixel: bool = True) -> np.ndarray:
    """(N, 7) packed peaks → (N, 2) of (dx, dy), in float64 on the host."""
    if isinstance(packed, torch.Tensor):
        packed = packed.cpu().numpy()
    p = np.asarray(packed, np.float64)
    dy, dx = p[:, 0].copy(), p[:, 1].copy()
    if subpixel:
        dy += _parabola(p[:, 3], p[:, 2], p[:, 4])
        dx += _parabola(p[:, 5], p[:, 2], p[:, 6])
    dy = np.where(dy > H / 2, dy - H, dy)
    dx = np.where(dx > W / 2, dx - W, dx)
    return np.stack([dx, dy], axis=-1)


def phase_correlate(ref: np.ndarray, frames: np.ndarray,
                    subpixel: bool = True,
                    device: DeviceLike = None) -> np.ndarray:
    """Phase correlation of (N, H, W) ``frames`` against the (H, W)
    ``ref`` on ``device``: (N, 2) of (dx, dy), the translation of the
    frame → ref transform (reg(x) = frame(x − d)); a frame whose content
    moved by +d from the reference gives −d."""
    dev = resolve_device(device)
    H, W = ref.shape[-2:]
    packed = phase_correlate_device(
        torch.as_tensor(np.asarray(ref, np.float32)).to(dev),
        torch.as_tensor(np.asarray(frames, np.float32)).to(dev))
    return decode_phasecorr_peaks(packed, H, W, subpixel)


@dataclass
class ShiftRegArgs:
    reglayer: int = 0
    selection: Optional[Tuple[int, int, int, int]] = None   # x, y, w, h
    subpixel: bool = True
    batch: int = 16


def register_shift_dft(seq: Sequence, args: Optional[ShiftRegArgs] = None,
                       device: DeviceLike = None):
    """DFT phase-correlation registration of a sequence (planetary full
    disc) on ``device``: translation-only H in the regdata, the reference
    frame's the identity; the ``.seq`` is written."""
    args = args or ShiftRegArgs()
    layer = args.reglayer
    ref_idx = seq.get_reference()
    ref_img = seq.read_frame(ref_idx).host()
    layer = min(layer, ref_img.shape[0] - 1)
    sel = args.selection
    if sel is None:
        # the largest centred power-of-two square
        side = 1 << int(np.floor(np.log2(min(seq.ry, seq.rx))))
        sel = ((seq.rx - side) // 2, (seq.ry - side) // 2, side, side)
    x0, y0, w, h = sel
    ref_c = ref_img[layer, y0:y0 + h, x0:x0 + w]
    reg = seq.reg(layer)
    indices = seq.selected_indices()
    for start in range(0, len(indices), args.batch):
        chunk = indices[start:start + args.batch]
        frames = np.stack([
            seq.read_frame(int(i)).host()[layer, y0:y0 + h, x0:x0 + w]
            for i in chunk])
        shifts = phase_correlate(ref_c, frames, args.subpixel, device)
        for k, idx in enumerate(chunk):
            Hm = np.eye(3)
            Hm[0, 2], Hm[1, 2] = shifts[k]
            reg.H[int(idx)] = Hm
            reg.valid[int(idx)] = True
    reg.H[ref_idx] = np.eye(3)
    seq.save()
    _log.info("DFT shift registration done (%d frames)", len(indices))
    return reg


def register_comet(seq: Sequence, pos1: Tuple[float, float], t1: str,
                   pos2: Tuple[float, float], t2: str, reglayer: int = 0):
    """Comet registration (comet.c): a linear velocity in px/hr between
    two picked positions, each frame shifted by its DATE-OBS (host)."""

    def parse(ts):
        return datetime.datetime.fromisoformat(ts.replace("Z", "+00:00"))

    dt_hours = (parse(t2) - parse(t1)).total_seconds() / 3600.0
    if dt_hours == 0:
        raise ValueError("comet registration needs two different times")
    vx = (pos2[0] - pos1[0]) / dt_hours
    vy = (pos2[1] - pos1[1]) / dt_hours
    reg = seq.reg(reglayer)
    t0 = None
    for i in seq.selected_indices():
        kw = seq.read_frame_metadata(int(i))
        if not kw.date_obs:
            continue
        t = parse(kw.date_obs)
        if t0 is None:
            t0 = t
        hours = (t - t0).total_seconds() / 3600.0
        Hm = np.eye(3)
        Hm[0, 2] = -vx * hours
        Hm[1, 2] = -vy * hours
        reg.H[int(i)] = Hm
        reg.valid[int(i)] = True
    seq.save()
    _log.info("Comet registration: velocity (%.3f, %.3f) px/hr", vx, vy)
    return reg


def template_match(ref_patch: np.ndarray, frames: np.ndarray,
                   device: DeviceLike = None) -> np.ndarray:
    """KOMBAT-style template match by FFT correlation with the zero-mean
    template on ``device``: (N, 2) positions (x, y) of each frame's best
    match, the first of equal maxima."""
    dev = resolve_device(device)
    th, tw = ref_patch.shape
    N, H, W = frames.shape
    t = torch.as_tensor(np.asarray(ref_patch, np.float32)).to(dev)
    f = torch.as_tensor(np.asarray(frames, np.float32)).to(dev)
    tm = t - t.mean()
    s = (H + th, W + tw)
    F = torch.fft.rfft2(f, s=s)
    T = torch.fft.rfft2(torch.flip(tm, (0, 1)), s=s)
    corr = torch.fft.irfft2(F * T[None], s=s)
    corr = corr[:, th - 1:H, tw - 1:W]
    am = torch.argmax(corr.reshape(N, -1), dim=1).cpu().numpy()
    nx = corr.shape[2]
    return np.stack([am % nx, am // nx], axis=-1).astype(np.float64)
