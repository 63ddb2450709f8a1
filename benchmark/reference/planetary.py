"""Plain reference of a multipoint planetary stack (Siril's ``mpp``, after
PlanetarySystemStacker): frame quality, the global shifts by phase
correlation against the best frame, the reference image, the quality of
each alignment point's patch, and the stack of the best patches of each
alignment point, each moved by its sub-pixel shift, blended with Hann
windows.

Plain torch on whatever device it is given, in float64 by default (the
control: bfloat16 data, the FFTs in float32, the lowest they take).  It
imports nothing of the program under test.  It follows the program's
alignment-point grid and multilevel-correlation shifts, which it does
not recompute; those are checked against the generator's truth."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference.serread import max_value


def frames(video: np.ndarray, idx, dev, dtype=torch.float64):
    """Frames ``idx`` of the video as [0, 1] values."""
    raw = torch.from_numpy(np.asarray(video[idx]).astype(np.int32)).to(dev)
    return (raw.double() / max_value(video)).to(dtype)


def quality(x: torch.Tensor) -> torch.Tensor:
    """(B, H, W) → (B,): the mean squared gradient of the 3×3
    box-smoothed frame (edges replicated), on the frame subsampled by 2
    and by 3, averaged."""
    q = 0
    for sub in (2, 3):
        xs = x[:, ::sub, ::sub]
        h, w = xs.shape[1], xs.shape[2]
        p = F.pad(xs[:, None], (1, 1, 1, 1), mode="replicate")[:, 0]
        sm = sum(p[:, 1 + dy:1 + dy + h, 1 + dx:1 + dx + w]
                 for dy in (-1, 0, 1) for dx in (-1, 0, 1)) / 9.0
        gx = sm[:, :, 1:] - sm[:, :, :-1]
        gy = sm[:, 1:, :] - sm[:, :-1, :]
        q = q + ((gx[:, :-1, :] ** 2).sum((1, 2))
                 + (gy[:, :, :-1] ** 2).sum((1, 2))) / (h * w)
    return q / 2


def _fft_dtype(x):
    return x if x.dtype in (torch.float32, torch.float64) else x.float()


def _parabola(cm, c0, cp):
    den = cm - 2.0 * c0 + cp
    off = np.clip(0.5 * (cm - cp) / np.where(den == 0, 1.0, den), -1, 1)
    return np.where(np.abs(den) < 1e-12, 0.0, off)


def phase_shifts(ref: torch.Tensor, x: torch.Tensor) -> np.ndarray:
    """(B, 2) (dx, dy) that move each frame onto ``ref``: the peak of the
    normalized cross-power spectrum's inverse, refined by a parabola
    through its neighbours on each axis, wrapped to ±half the frame."""
    H, W = ref.shape
    R = torch.fft.rfft2(_fft_dtype(ref))
    X = torch.fft.rfft2(_fft_dtype(x))
    c = R[None] * torch.conj(X)
    c = c / torch.clamp(c.abs(), min=1e-12)
    corr = torch.fft.irfft2(c, s=(H, W))
    am = torch.argmax(corr.reshape(corr.shape[0], -1), 1)
    py, px = am // W, am % W
    b = torch.arange(corr.shape[0], device=corr.device)

    def at(dy, dx):
        return corr[b, (py + dy) % H, (px + dx) % W].double().cpu().numpy()

    c0 = at(0, 0)
    dy = py.cpu().numpy() + _parabola(at(-1, 0), c0, at(1, 0))
    dx = px.cpu().numpy() + _parabola(at(0, -1), c0, at(0, 1))
    dy = np.where(dy > H / 2, dy - H, dy)
    dx = np.where(dx > W / 2, dx - W, dx)
    return np.stack([dx, dy], -1)


def fourier_shift(x: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """(B, H, W) moved by (B, 2) (dx, dy) (out(p) = in(p − d)) with the
    phase ramp exp(−2πi f·d); the inverse over the rows, then the real
    inverse over the columns with the imaginary parts of the first and
    the Nyquist column dropped (numpy's ``irfft2``)."""
    H, W = x.shape[-2:]
    xx = _fft_dtype(x)
    fy = torch.fft.fftfreq(H, device=x.device, dtype=xx.dtype)[None, :, None]
    fx = torch.fft.rfftfreq(W, device=x.device, dtype=xx.dtype)[None, None]
    d = d.to(xx.dtype)
    theta = -2.0 * np.pi * (d[:, 0, None, None] * fx
                            + d[:, 1, None, None] * fy)
    Y = torch.fft.ifft(torch.fft.rfft2(xx) * torch.polar(
        torch.ones_like(theta), theta), dim=-2)
    cols = [0] + ([W // 2] if W % 2 == 0 else [])
    Y[..., cols] = Y[..., cols].real.to(Y.dtype)
    return torch.fft.irfft(Y, n=W, dim=-1).to(x.dtype)


@dataclass
class MppParams:
    ap_size: int = 48
    global_best_pct: float = 25.0
    stack_best_pct: float = 50.0
    batch: int = 50


def origins(ap_xy: np.ndarray, S: int, H: int, W: int):
    half = S // 2
    oy = np.clip(ap_xy[:, 1].astype(int) - half, 0, H - S)
    ox = np.clip(ap_xy[:, 0].astype(int) - half, 0, W - S)
    return oy, ox


def _cut(x: torch.Tensor, oy, ox, S: int) -> torch.Tensor:
    """(B, A, S, S) windows of (B, H, W) ``x`` at origins (A,) or (B, A)."""
    oy = torch.as_tensor(np.asarray(oy), device=x.device)
    ox = torch.as_tensor(np.asarray(ox), device=x.device)
    B = x.shape[0]
    if oy.dim() == 1:
        oy, ox = oy[None].expand(B, -1), ox[None].expand(B, -1)
    r = torch.arange(S, device=x.device)
    b = torch.arange(B, device=x.device)[:, None, None, None]
    return x[b, (oy[:, :, None] + r)[:, :, :, None],
             (ox[:, :, None] + r)[:, :, None, :]]


def analyse(video, dev, p: MppParams, dtype=torch.float64):
    """Frame quality, the global shifts against the best frame."""
    n = video.shape[0]
    q = torch.cat([quality(frames(video, slice(b, b + p.batch), dev, dtype))
                   for b in range(0, n, p.batch)]).double().cpu().numpy()
    best = int(np.argmax(q))
    ref = frames(video, [best], dev, dtype)[0]
    g = np.concatenate([phase_shifts(ref, frames(
        video, slice(b, b + p.batch), dev, dtype))
        for b in range(0, n, p.batch)])
    return q, g


def reference_image(video, q, gshifts, dev, p: MppParams,
                    dtype=torch.float64) -> np.ndarray:
    """The mean of the best ``global_best_pct`` % frames, each moved by its
    global shift."""
    n = video.shape[0]
    k = max(int(round(n * p.global_best_pct / 100.0)), 1)
    best = np.sort(np.argsort(-q)[:k])
    acc = 0
    for b in range(0, k, p.batch):
        idx = best[b:b + p.batch]
        sh = torch.as_tensor(gshifts[idx], device=dev)
        acc = acc + fourier_shift(frames(video, idx, dev, dtype),
                                  sh).double().sum(0)
    return (acc / k).cpu().numpy()


def patch_quality(video, gshifts, ap_xy, dev, p: MppParams,
                  dtype=torch.float64) -> np.ndarray:
    """(N, A): the quality of each alignment point's patch of each
    globally aligned frame."""
    n = video.shape[0]
    H, W = video.shape[1:]
    S = p.ap_size
    oy, ox = origins(ap_xy, S, H, W)
    out = []
    for b in range(0, n, p.batch):
        sl = slice(b, min(n, b + p.batch))
        x = fourier_shift(frames(video, sl, dev, dtype),
                          torch.as_tensor(gshifts[sl], device=dev))
        pt = _cut(x, oy, ox, S)
        out.append(quality(pt.reshape(-1, S, S)).reshape(pt.shape[:2])
                   .double().cpu().numpy())
    return np.concatenate(out)


def stack(video, gshifts, ap_xy, ap_shifts, ap_quality, reference, dev,
          p: MppParams, dtype=torch.float64) -> np.ndarray:
    """Per alignment point the best ``stack_best_pct`` % frames by patch
    quality, each patch cut at its whole-pixel origin in the globally
    aligned frame and moved by its sub-pixel rest, summed; the sums
    blended with Hann windows; the reference image where no point
    reaches; clipped to [0, 1]."""
    n = video.shape[0]
    H, W = video.shape[1:]
    S, half = p.ap_size, p.ap_size // 2
    A = len(ap_xy)
    keep = max(int(round(n * p.stack_best_pct / 100.0)), 1)
    sel = np.argsort(-ap_quality, axis=0)[:keep]
    selm = np.zeros((n, A))
    np.put_along_axis(selm, sel, 1.0, axis=0)
    acc_ap = torch.zeros((A, S, S), dtype=torch.float64, device=dev)
    for b in range(0, n, p.batch):
        sl = slice(b, min(n, b + p.batch))
        cx = ap_xy[None, :, 0] - ap_shifts[sl, :, 0]
        cy = ap_xy[None, :, 1] - ap_shifts[sl, :, 1]
        ix = np.clip(np.round(cx) - half, 0, W - S).astype(np.int64)
        iy = np.clip(np.round(cy) - half, 0, H - S).astype(np.int64)
        rest = np.stack([cx - (ix + half), cy - (iy + half)], -1)
        x = fourier_shift(frames(video, sl, dev, dtype),
                          torch.as_tensor(gshifts[sl], device=dev))
        pt = _cut(x, iy, ix, S)
        B = pt.shape[0]
        moved = fourier_shift(pt.reshape(B * A, S, S), -torch.as_tensor(
            rest.reshape(-1, 2), device=dev)).reshape(B, A, S, S)
        m = torch.as_tensor(selm[sl], device=dev)
        acc_ap += (moved.double() * m[:, :, None, None]).sum(0)
    sums = acc_ap.cpu().numpy()
    win = np.hanning(S)[:, None] * np.hanning(S)[None, :]
    acc = np.zeros((H, W))
    wacc = np.zeros((H, W))
    oy, ox = origins(ap_xy, S, H, W)
    counts = selm.sum(0)
    for a in range(A):
        acc[oy[a]:oy[a] + S, ox[a]:ox[a] + S] += sums[a] * win
        wacc[oy[a]:oy[a] + S, ox[a]:ox[a] + S] += win * counts[a]
    out = np.where(wacc > 1e-6, acc / np.maximum(wacc, 1e-6), reference)
    return np.clip(out, 0.0, 1.0)
