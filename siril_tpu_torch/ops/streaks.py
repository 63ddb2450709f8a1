"""Satellite-trail (streak) detection — counterpart of
``siril_tpu/ops/streaks.py`` (``Track``:32, ``StreakConf``:41, the ksigma
schedule ``_ksigma_f``:47, ``_hough_lines``:54, ``_line_endpoints``:92,
``detect_streaks``:109; reference ``src/algos/line_detection.c`` and
``src/opencv/tracks.cpp``).

The layer is binarized at median + k·σ (σ = 1.4826·MAD), k falling on an
exponential schedule, and a Hough transform looks for lines at least the
requested length; the length halves until a track is found.

On the device: the median and MAD (exact, by a sort), the threshold and
the Hough vote, ρ = x·cosθ + y·sinθ in float32 rounded half to even, as
one ``bincount`` over points × angles in chunks.  On the host: the peak
picker, which sorts the accumulator with ``np.argsort(flat)[::-1]`` — not
a stable sort, and ties between equal votes decide which lines survive
the duplicate test, so the accumulator is fetched and sorted by the same
numpy call — and the endpoints.  The length loop only changes the vote
needed, so the points, the peaks and their endpoints are taken once per
threshold.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np
import torch

from siril_tpu_torch.device import DeviceLike, resolve_device
from siril_tpu_torch.ops.statistics import median_t

# line_detection.c: KSIGMA_INITIAL_FACTOR * min_ksigma start, exp decay
KSIGMA_MINIMAL_VALUE = 1.3
KSIGMA_INITIAL_FACTOR = 8.0
MAX_KSIGMA_IDX = 10

#: points × angles of one chunk of the vote
_VOTE_CHUNK = 1 << 24


@dataclass
class Track:
    start: Tuple[float, float]
    end: Tuple[float, float]
    angle_deg: float
    length: float
    votes: int


@dataclass
class StreakConf:
    initial_length: int = 0          # 0 → 500 (line_detection.c:46)
    min_allowed_length: int = 0      # 0 → max(25, 0.5% of width)
    min_allowed_ksigma: float = 0.0  # 0 → KSIGMA_MINIMAL_VALUE
    theta_bins: int = 360
    max_points: int = 200_000


def _ksigma_f(x: int, initial: float, minimal: float) -> float:
    """Exponential ksigma decay schedule (line_detection.c:25-30)."""
    if x >= MAX_KSIGMA_IDX:
        return minimal
    return minimal + (initial - minimal) * math.exp(-0.50 * x)


def _thetas(theta_bins: int) -> np.ndarray:
    return np.linspace(0.0, math.pi, theta_bins, endpoint=False)


def hough_accumulator(ys: torch.Tensor, xs: torch.Tensor, shape,
                      theta_bins: int) -> np.ndarray:
    """The (2·diag + 1, T) int32 vote of float32 points (ys, xs) where
    they lie: ρ = x·cosθ + y·sinθ (float32 products and sum, no fused
    multiply-add), rounded half to even, offset by diag."""
    h, w = shape
    diag = int(math.ceil(math.hypot(h, w)))
    thetas = _thetas(theta_bins)
    dev = xs.device
    cos_t = torch.from_numpy(np.cos(thetas).astype(np.float32)).to(dev)
    sin_t = torch.from_numpy(np.sin(thetas).astype(np.float32)).to(dev)
    t_idx = torch.arange(theta_bins, device=dev)
    nbins = (2 * diag + 1) * theta_bins
    acc = torch.zeros(nbins, dtype=torch.int64, device=dev)
    step = max(1, _VOTE_CHUNK // theta_bins)
    for p0 in range(0, xs.numel(), step):
        x = xs[p0:p0 + step, None]
        y = ys[p0:p0 + step, None]
        rho = x * cos_t[None, :] + y * sin_t[None, :]
        r_idx = torch.round(rho).to(torch.int64) + diag
        acc += torch.bincount((r_idx * theta_bins + t_idx).reshape(-1),
                              minlength=nbins)
    return acc.reshape(2 * diag + 1, theta_bins).to(torch.int32).cpu() \
        .numpy()


def hough_peaks(acc: np.ndarray, diag: int, min_votes: int,
                theta_bins: int) -> List[Tuple[float, float, int]]:
    """(ρ, θ, votes) of the accumulator's peaks (``_hough_lines``:69-89):
    the 256 largest cells by numpy's argsort, near-duplicates (Δρ < 10,
    Δθ < 3°) dropped."""
    thetas = _thetas(theta_bins)
    peaks = []
    flat = acc.ravel()
    if flat.max() < min_votes:      # the loop below would stop at once
        return peaks
    order = np.argsort(flat)[::-1]
    taken = []
    for k in order[:256]:
        v = int(flat[k])
        if v < min_votes:
            break
        r_i, t_i = divmod(int(k), theta_bins)
        dup = False
        for (pr, pt) in taken:
            dt = min(abs(t_i - pt), theta_bins - abs(t_i - pt))
            if abs(r_i - pr) < 10 and dt < theta_bins * 3 // 180 + 1:
                dup = True
                break
        if dup:
            continue
        taken.append((r_i, t_i))
        peaks.append((float(r_i - diag), float(thetas[t_i]), v))
    return peaks


def _line_endpoints(ys, xs, rho, theta, tol=3.0):
    """Project inlier pixels onto the line to recover segment endpoints."""
    c, s = math.cos(theta), math.sin(theta)
    d = xs * c + ys * s - rho
    m = np.abs(d) < tol
    if not m.any():
        return None
    # position along the line direction (-sinθ, cosθ)
    t = -xs[m] * s + ys[m] * c
    i0, i1 = int(np.argmin(t)), int(np.argmax(t))
    xm, ym = xs[m], ys[m]
    p0 = (float(xm[i0]), float(ym[i0]))
    p1 = (float(xm[i1]), float(ym[i1]))
    length = math.hypot(p1[0] - p0[0], p1[1] - p0[1])
    return p0, p1, length


def detect_streaks_tensor(img: torch.Tensor,
                          conf: StreakConf = None) -> List[Track]:
    """``detect_streaks`` of one float32 (H, W) layer where it lies."""
    conf = conf or StreakConf()
    h, w = img.shape
    med = float(median_t(img))
    noise = 1.4826 * float(median_t(torch.abs(
        img - torch.tensor(np.float32(med), device=img.device)))) or 1e-6
    min_len = conf.initial_length or 500
    min_len = min(min_len, int(0.9 * min(h, w)))
    min_allowed_len = conf.min_allowed_length or max(25, round(w * 0.005))
    min_ks = conf.min_allowed_ksigma or KSIGMA_MINIMAL_VALUE
    initial_ks = KSIGMA_INITIAL_FACTOR * min_ks
    diag = int(math.ceil(math.hypot(h, w)))

    votes: Dict[int, tuple] = {}

    def at(ks_idx):
        """(ys, xs, peaks, endpoints) of one threshold, or None (no point
        or too many).  The peaks are taken once at the smallest vote any
        length asks for (20): a length's peaks are their prefix with
        enough votes, as the JAX package's loop stops at the first peak
        with too few; the endpoints of a peak are kept across lengths."""
        if ks_idx not in votes:
            ks = _ksigma_f(ks_idx, initial_ks, min_ks)
            thr = torch.tensor(np.float32(med + ks * noise),
                               device=img.device)
            yx = torch.nonzero(img > thr)
            n = yx.shape[0]
            if n == 0 or n > conf.max_points:
                votes[ks_idx] = None
            else:
                yx = yx.to(torch.float32)
                acc = hough_accumulator(yx[:, 0], yx[:, 1], (h, w),
                                        conf.theta_bins)
                yx = yx.cpu().numpy()
                votes[ks_idx] = (yx[:, 0], yx[:, 1],
                                 hough_peaks(acc, diag, 20,
                                             conf.theta_bins), {})
        return votes[ks_idx]

    length = min_len
    while length >= min_allowed_len:
        for ks_idx in range(MAX_KSIGMA_IDX + 1):
            got = at(ks_idx)
            if got is None:
                continue
            ys, xs, peaks, ends = got
            # votes threshold ~ half the requested length in pixels
            min_votes = max(20, length // 2)
            tracks = []
            for k, (rho, theta, v) in enumerate(peaks):
                if v < min_votes:
                    break
                if k not in ends:
                    ends[k] = _line_endpoints(ys, xs, rho, theta)
                ep = ends[k]
                if ep is None:
                    continue
                p0, p1, ln = ep
                if ln < length:
                    continue
                # fill factor: a real trail lights up most of its extent
                if v < 0.35 * ln:
                    continue
                ang = math.degrees(math.atan2(p1[1] - p0[1],
                                              p1[0] - p0[0]))
                tracks.append(Track(p0, p1, ang, ln, v))
            if tracks:
                return tracks
        length //= 2
    return []


def detect_streaks(data: np.ndarray, conf: StreakConf = None,
                   layer: int = 0, device: DeviceLike = None) -> List[Track]:
    """Linear tracks in one layer of ``data`` ([C, H, W] or [H, W]
    float32) on ``device`` (``detect_streaks``:109)."""
    img = data[layer] if data.ndim == 3 else data
    x = torch.from_numpy(np.ascontiguousarray(img, np.float32)).to(
        resolve_device(device))
    return detect_streaks_tensor(x, conf)
