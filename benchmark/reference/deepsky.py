"""Plain reference of a deep-sky stack: calibration with the masters and
the cosmetic correction from the dark, the per-frame IKSS estimators and
the normalization coefficients, the lanczos4 translation warp with its
clamp, winsorized sigma clipping and the mean, as Siril defines them
(``preprocess.c``, ``cosmetic_correction.c``, ``normalization.c``,
``opencv`` lanczos4 with Siril's clamp, ``rejection_float.c``).

Plain torch on whatever device it is given, in float64 by default; the
lower-precision control runs the same code in bfloat16.  It imports
nothing of the program under test and takes none of its state, except
the per-frame shifts the program's registration found, which it follows
(the registration itself is checked against the generator's truth)."""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np
import torch

CLAMPING_FACTOR = 0.98
WINSOR_MAX_STEPS = 1000


@dataclass
class StackParams:
    norm: str = "addscale"          # "addscale" or "mul"
    siglow: float = 3.0
    sighigh: float = 3.0
    ref_frame: int = 0


# ---------------------------------------------------------------------------
# calibration
# ---------------------------------------------------------------------------


def hot_pixels(dark: torch.Tensor, sig_hot: float) -> torch.Tensor:
    """Pixels of the master dark at or above median + k·sigma (sigma the
    sample standard deviation) of its non-zero pixels, capped at 1."""
    good = dark[(dark != 0) & torch.isfinite(dark)]
    med = float(_median_1d(good))
    sd = float(good.std())
    return dark >= min(med + sig_hot * sd, 1.0)


def _median_1d(v: torch.Tensor) -> torch.Tensor:
    s = torch.sort(v).values
    n = s.numel()
    return 0.5 * (s[(n - 1) // 2] + s[n // 2])


def calibrate(raw: torch.Tensor, bias: Optional[torch.Tensor],
              dark: Optional[torch.Tensor], flat: Optional[torch.Tensor],
              hot: Optional[torch.Tensor]) -> torch.Tensor:
    """(raw − bias − dark) / (flat / mean(flat)); then each hot pixel
    takes the mean of its 8 neighbours (edge replicated), read before
    any replacement."""
    x = raw
    if bias is not None:
        x = x - bias
    if dark is not None:
        x = x - dark
    if flat is not None:
        fnorm = flat / flat.mean()
        x = torch.where(fnorm == 0, torch.zeros_like(x),
                        x / torch.where(fnorm == 0, 1.0, fnorm))
    if hot is not None and bool(hot.any()):
        p = torch.nn.functional.pad(x[None, None], (1, 1, 1, 1),
                                    mode="replicate")[0, 0]
        H, W = x.shape
        nb = sum(p[1 + dy:1 + dy + H, 1 + dx:1 + dx + W]
                 for dy in (-1, 0, 1) for dx in (-1, 0, 1)
                 if (dy, dx) != (0, 0)) / 8
        x = torch.where(hot, nb.to(x.dtype), x)
    return x


# ---------------------------------------------------------------------------
# estimators and coefficients
# ---------------------------------------------------------------------------


def _median_of(x: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
    v = x[keep]
    return _median_1d(v) if v.numel() else torch.zeros((), dtype=x.dtype,
                                                       device=x.device)


def ikss(frame: torch.Tensor):
    """(location, scale) of a frame's non-zero finite pixels: the median
    and MAD, the pixels within ±6 MAD, their median (location) and
    0.991·sqrt of their biweight midvariance (scale; 1.5·MAD where it is
    0)."""
    x = frame.reshape(-1)
    valid = (x != 0) & torch.isfinite(x)
    med = _median_of(x, valid)
    mad = _median_of((x - med).abs(), valid)
    keep = valid & (x >= med - 6 * mad) & (x <= med + 6 * mad)
    loc = _median_of(x, keep)
    mad2 = _median_of((x - loc).abs(), keep)
    d = x[keep] - loc
    y = d / (9.0 * torch.clamp_min(mad2, 1e-30))
    y2 = torch.where(y.abs() < 1, y * y, torch.ones_like(y))
    one = 1.0 - y2
    up = ((d * one * one) ** 2).sum()
    dn = (one * (1.0 - 5.0 * y2)).sum()
    bwmv = keep.sum() * up / (dn * dn) if float(dn) != 0 else 0.0 * up
    scale = torch.sqrt(bwmv) * 0.991
    return float(loc), float(scale) if float(scale) > 0 else 1.5 * float(mad)


def coefficients(locs: Sequence[float], scales: Sequence[float], norm: str,
                 ref: int):
    """Per-frame (scale, offset, mul): additive with scaling normalizes
    x·scale − offset, scale = s_ref / s and offset = scale·loc − loc_ref;
    multiplicative x·mul, mul = loc_ref / loc."""
    loc = np.asarray(locs, np.float64)
    sca = np.asarray(scales, np.float64)
    n = len(loc)
    scale, offset, mul = np.ones(n), np.zeros(n), np.ones(n)
    if norm == "addscale":
        scale = np.where(sca == 0, 1.0, sca[ref] / np.where(sca == 0, 1, sca))
        offset = scale * loc - loc[ref]
    elif norm == "mul":
        mul = np.where(loc == 0, 1.0, loc[ref] / np.where(loc == 0, 1, loc))
    else:
        raise ValueError(f"normalization {norm!r} not in the reference")
    return scale, offset, mul


# ---------------------------------------------------------------------------
# the translation warp
# ---------------------------------------------------------------------------


def lanczos4(t: float) -> List[float]:
    """Normalized lanczos4 weights of the taps −3 … 4 around fraction t."""
    w = []
    for k in range(-3, 5):
        x = t - k
        if abs(x) < 1e-12:
            w.append(1.0)
        elif abs(x) >= 4:
            w.append(0.0)
        else:
            px = math.pi * x
            w.append(4 * math.sin(px) * math.sin(px / 4) / (px * px))
    s = sum(w)
    return [v / s for v in w]


def shift_frame(frame: torch.Tensor, dx: float, dy: float) -> torch.Tensor:
    """out(x, y) = in(x − dx, y − dy) with lanczos4, taps outside the
    frame reading 0, then the clamp: where the result falls below 0.98
    of the bilinear value, in a 3×3 neighbourhood (wrapping at the
    edges), the bilinear value."""
    H, W = frame.shape
    sx, sy = -dx, -dy
    ix, iy = math.floor(sx), math.floor(sy)
    fx, fy = sx - ix, sy - iy
    pad = max(abs(ix), abs(iy)) + 6
    big = torch.nn.functional.pad(frame[None, None], (pad,) * 4)[0, 0]

    def at(ky, kx):
        y0, x0 = pad + iy + ky, pad + ix + kx
        return big[y0:y0 + H, x0:x0 + W]

    wy, wx = lanczos4(fy), lanczos4(fx)
    rows = [sum(wx[j] * big[pad + iy + ky:pad + iy + ky + H,
                            pad + ix + j - 3:pad + ix + j - 3 + W]
                for j in range(8)) for ky in range(-3, 5)]
    acc = sum(wy[i] * rows[i] for i in range(8))
    guide = (1 - fy) * ((1 - fx) * at(0, 0) + fx * at(0, 1)) + \
        fy * ((1 - fx) * at(1, 0) + fx * at(1, 1))
    low = acc < CLAMPING_FACTOR * guide
    m = low.clone()
    for ddy in (-1, 0, 1):
        for ddx in (-1, 0, 1):
            m |= torch.roll(low, shifts=(ddy, ddx), dims=(0, 1))
    return torch.where(m, guide, acc)


# ---------------------------------------------------------------------------
# winsorized clipping and the mean
# ---------------------------------------------------------------------------


def _nth_kept(xs: torch.Tensor, kept: torch.Tensor, k: torch.Tensor):
    """The k-th (0-based) kept value of each column of sorted ``xs``."""
    c = torch.cumsum(kept.int(), 0)
    hit = kept & (c == (k + 1)[None])
    idx = torch.argmax(hit.int(), 0)
    return xs.gather(0, idx[None])[0]


def _median_kept(xs, kept, n):
    lo = _nth_kept(xs, kept, torch.clamp_min((n - 1) // 2, 0))
    hi = _nth_kept(xs, kept, torch.clamp_min(n // 2, 0))
    return 0.5 * (lo + hi)


def _sd(v: torch.Tensor, kept: torch.Tensor, n: torch.Tensor):
    nn = torch.clamp_min(n, 1).to(v.dtype)
    z = torch.zeros_like(v)
    mean = torch.where(kept, v, z).sum(0) / nn
    d = torch.where(kept, v - mean, z)
    var = (d * d).sum(0) / torch.clamp_min(nn - 1, 1)
    return torch.where(n > 1, torch.sqrt(var), torch.zeros_like(mean))


def winsorized_mean(stack: torch.Tensor, siglow: float, sighigh: float):
    """Winsorized sigma clipping and the mean of each column of an (N, P)
    stack of normalized values (zeros and non-finite values are not
    data).  Per pixel, until a round rejects nothing or 3 values are
    left: the median m and sd σ of the kept values; the kept values
    clamped to m ± 1.5σ again and again, σ ← 1.134·sd of the clamped
    values, until σ moves by at most 5e-4 of itself; then a value below
    m − siglow·σ or above m + sighigh·σ is rejected, low before high in
    ascending order, and no more once the kept count less the rejections
    so far reaches 4.  A column of one value keeps it; a column left
    empty takes the median of the whole column, invalid values as 0.
    Returns (mean, rejected low, rejected high)."""
    N, P = stack.shape
    valid = (stack != 0) & torch.isfinite(stack)
    inf = torch.full_like(stack, float("inf"))
    xs = torch.sort(torch.where(valid, stack, inf), 0).values
    nvalid = valid.sum(0)
    kept = torch.arange(N, device=stack.device)[:, None] < nvalid[None]
    active = nvalid > 1
    r = torch.zeros_like(nvalid)
    rejl, rejh = torch.zeros_like(nvalid), torch.zeros_like(nvalid)
    xs0 = torch.where(kept, xs, torch.zeros_like(xs))
    while bool(active.any()):
        n = kept.sum(0)
        med = _median_kept(xs, kept, n)
        sigma = _sd(xs0, kept, n)
        w = xs0.clone()
        frozen = ~active | (n <= 1)
        for _ in range(WINSOR_MAX_STEPS):
            if bool(frozen.all()):
                break
            w = torch.minimum(torch.maximum(w, med - 1.5 * sigma),
                              med + 1.5 * sigma)
            new = 1.134 * _sd(w, kept, n)
            conv = (new - sigma).abs() <= sigma * 5e-4
            sigma = torch.where(frozen, sigma, new)
            frozen = frozen | conv
        low = kept & ((med - xs) > sigma * siglow) & active
        high = kept & ((xs - med) > sigma * sighigh) & active
        budget = torch.clamp_min(n - r - 4, 0)
        cl = torch.cumsum(low.int(), 0)
        rl = low & (cl <= budget)
        nl = rl.sum(0)
        ch = torch.cumsum(high.int(), 0)
        rh = high & (ch <= budget - nl)
        nh = rh.sum(0)
        kept = kept & ~rl & ~rh
        r = r + nl + nh
        rejl, rejh = rejl + nl, rejh + nh
        changed = (nl + nh) > 0
        active = active & changed & (kept.sum(0) > 3)
    n = kept.sum(0)
    mean = torch.where(kept, xs0, torch.zeros_like(xs0)).sum(0) / \
        torch.clamp_min(n, 1).to(stack.dtype)
    allv = torch.sort(torch.where(valid, stack, torch.zeros_like(stack)),
                      0).values
    med_all = 0.5 * (allv[(N - 1) // 2] + allv[N // 2])
    mean = torch.where(n > 0, mean, med_all)
    trivial = nvalid <= 1
    zero = torch.zeros_like(rejl)
    return mean, torch.where(trivial, zero, rejl), \
        torch.where(trivial, zero, rejh)


# ---------------------------------------------------------------------------
# the whole stack
# ---------------------------------------------------------------------------


@dataclass
class Stacked:
    image: np.ndarray              # (H, W) float64, clipped to [0, 1]
    rejected: tuple                # (low, high) totals


def stack(frames: List[torch.Tensor], shifts: Optional[np.ndarray],
          sp: StackParams, block_pixels: int = 1 << 22) -> Stacked:
    """Estimators on the calibrated frames, the warp by ``shifts`` ((N, 2)
    (dx, dy) frame → reference, or None), normalization, winsorized
    clipping and the mean over row blocks; the result clipped to
    [0, 1]."""
    est = [ikss(f) for f in frames]
    locs = np.array([e[0] for e in est])
    scas = np.array([e[1] for e in est])
    scale, offset, mul = coefficients(locs, scas, sp.norm, sp.ref_frame)
    if shifts is not None:
        frames = [shift_frame(f, float(dx), float(dy))
                  for f, (dx, dy) in zip(frames, shifts)]
    H, W = frames[0].shape
    dt, dev = frames[0].dtype, frames[0].device
    sc = torch.as_tensor(scale, device=dev).to(dt)[:, None]
    off = torch.as_tensor(offset, device=dev).to(dt)[:, None]
    mu = torch.as_tensor(mul, device=dev).to(dt)[:, None]
    rows = max(1, block_pixels // W)
    out = np.empty((H, W))
    tl = th = 0
    for y0 in range(0, H, rows):
        y1 = min(H, y0 + rows)
        x = torch.stack([f[y0:y1].reshape(-1) for f in frames])
        if sp.norm == "addscale":
            x = torch.where(x != 0, x * sc - off, x)
        else:
            x = x * mu
        m, rl, rh = winsorized_mean(x, sp.siglow, sp.sighigh)
        out[y0:y1] = m.double().reshape(y1 - y0, W).cpu().numpy()
        tl += int(rl.sum())
        th += int(rh.sum())
    return Stacked(np.clip(out, 0.0, 1.0), (tl, th))
