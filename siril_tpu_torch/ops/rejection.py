"""Pixel-rejection stacking, plain PyTorch version — counterpart of
``siril_tpu/ops/rejection.py`` (``rejection_mean``:548) for every mode:
NO_REJEC, PERCENTILE (``_percentile``:248), SIGMA and MAD
(``_sigma_or_mad``:188), WINSORIZED (``_winsorized``:268), SIGMEDIAN
(``_sigmedian``:361), LINEARFIT (``_linearfit``:391) and GESDT
(``_gesdt``:474, λ table ``gesdt_critical_values``:457), with the
weighted mean of ``rejection_mean``:622-635.

This is the plain version of kernel K1 (``kernels/reject_stack.py``): the
CPU path, and the function the CUDA kernel is held against on the card.
After sorting each pixel's frame vector (invalid entries pushed to +inf)
the window modes keep a window [lo, hi) plus, after a guard truncation, a
kept-top segment; LINEARFIT and GESDT keep a mask over the sorted values;
SIGMEDIAN replaces values by the running median and re-sorts each round,
as the Pallas kernel does (pallas/reject_stack.py:478-519).

Every sum over the frame axis runs in row order, k = 0 … N−1
(``_colsum``), the order the CUDA kernel's per-thread loops use.  Where
XLA contracts a multiply-add into one fused multiply-add (``c − a·b`` in
the window variance, the winsorized clip bounds, and the LINEARFIT
intercept ``m_y − m_x·a`` and line ``a·pos + b``; XLA:CPU does this in its
elementwise fusions), this version computes it with one rounding too
(``fma``), and so does the kernel (``__fmaf_rn``): the one-pass variance
cancels badly in float32, and a different rounding there moves σ by ~1e-4
relative, enough to flip a candidate near kσ.  The winsorized σ loop is
the exact C iteration (rejection_float.c:222-236), with no extrapolation
and no early stop before ``WINSOR_MAX_STEPS``.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

# rejection types (settings.h:43-52)
NO_REJEC = 0
PERCENTILE = 1
SIGMA = 2
MAD = 3
SIGMEDIAN = 4
WINSORIZED = 5
LINEARFIT = 6
GESDT = 7

REJECTION_NAMES = {
    "n": NO_REJEC, "none": NO_REJEC,
    "p": PERCENTILE, "percentile": PERCENTILE,
    "s": SIGMA, "sigma": SIGMA,
    "m": MAD, "mad": MAD,
    "a": SIGMEDIAN, "sigmedian": SIGMEDIAN,
    "w": WINSORIZED, "winsorized": WINSORIZED,
    "l": LINEARFIT, "linear": LINEARFIT, "linearfit": LINEARFIT,
    "g": GESDT, "gesdt": GESDT, "generalized": GESDT,
}

#: the modes whose kept set is a sorted window (kernel K1a)
WINDOW_MODES = frozenset({NO_REJEC, PERCENTILE, SIGMA, MAD, WINSORIZED})
ALL_MODES = WINDOW_MODES | {SIGMEDIAN, LINEARFIT, GESDT}

#: SIGMEDIAN stops after this many replacement rounds.  The reference loops
#: until nothing is replaced; the bound keeps a pathological column from
#: spinning a kernel thread forever.  The kernel uses the same bound, and
#: both versions count the pixels that stop at it (``capped``).
SIGMEDIAN_MAX_ROUNDS = 1000

#: The winsorized σ iteration stops after this many steps of one clipping
#: round.  The reference iterates until σ settles; the bound keeps a
#: column from spinning forever.  The kernel uses the same bound, and both
#: versions count the clipping rounds that stop at it (``capped``).
WINSOR_MAX_STEPS = 1000

_INF = float("inf")


def check_rtype(rtype: int) -> None:
    if rtype not in ALL_MODES:
        raise ValueError(f"unknown rejection type {rtype}")


def fma(a, b, c) -> torch.Tensor:
    """a·b + c in float32 with a single rounding, as a fused multiply-add
    computes it: the float32 product is exact in float64, and the float64
    sum rounds to float32 the same way except on a double-rounding tie
    (probability ~2⁻²⁹ per call)."""
    a, b, c = (torch.as_tensor(v, dtype=torch.float64) if not
               isinstance(v, torch.Tensor) else v.double() for v in (a, b, c))
    return (a * b + c).float()


def _colsum(planes: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Σ over the frame axis of ``planes`` where ``mask``, in frame order."""
    acc = torch.zeros_like(planes[0])
    for k in range(planes.shape[0]):
        acc = acc + torch.where(mask[k], planes[k], 0.0)
    return acc


def _rows(xs: torch.Tensor) -> torch.Tensor:
    return torch.arange(xs.shape[0], device=xs.device,
                        dtype=torch.int32)[:, None]


def _window_median(xs, lo, hi):
    """Exact median of sorted xs[lo:hi] per pixel (mean of the middle pair
    for an even count); an index past the last row reads 0."""
    N = xs.shape[0]
    n = torch.clamp_min(hi - lo, 1)
    i0 = lo + torch.div(n - 1, 2, rounding_mode="floor")
    i1 = lo + torch.div(n, 2, rounding_mode="floor")

    def at(i):
        v = xs.gather(0, torch.clamp(i, 0, N - 1).long()[None])[0]
        return torch.where(i < N, v, 0.0)

    return 0.5 * (at(i0) + at(i1))


def _window_mean_sd(s1, s2, lo, hi):
    """Mean and sample sd (N−1) of the window [lo, hi)."""
    rows = _rows(s1)
    inwin = (rows >= lo) & (rows < hi)
    n = (hi - lo).float()
    t1 = _colsum(s1, inwin)
    t2 = _colsum(s2, inwin)
    mean = t1 / torch.clamp_min(n, 1.0)
    var = fma(-t1, mean, t2) / torch.clamp_min(n - 1.0, 1.0)
    sd = torch.sqrt(torch.clamp_min(var, 0.0))
    return mean, torch.where(n > 1, sd, 0.0)


class _Window:
    """Per-pixel window state of the clipping loops."""

    def __init__(self, nvalid: torch.Tensor):
        zero = torch.zeros_like(nvalid)
        self.lo, self.hi, self.r = zero, nvalid.clone(), zero
        self.rejl, self.rejh = zero, zero
        self.seg_lo, self.seg_hi = zero, zero

    def clip(self, xs, center, spread, siglow, sighigh, active):
        """One clipping round with the cumulative N−r≤4 guard
        (rejection_float.c:188-196) in closed form: low candidates are a
        prefix of the sorted window and high candidates a suffix.  When
        the guard truncates the high side, the ascending C scan keeps the
        largest high candidates: that top slice becomes the kept segment
        (truncation is terminal).  Returns the per-pixel changed mask."""
        rows = _rows(xs)
        lo, hi = self.lo, self.hi
        inwin = (rows >= lo) & (rows < hi)
        low = inwin & ((center - xs) > spread * siglow)
        high = inwin & ((xs - center) > spread * sighigh)
        ncl = torch.where(active, low.sum(0, dtype=torch.int32), 0)
        nch = torch.where(active, high.sum(0, dtype=torch.int32), 0)
        max_acc = torch.clamp_min(hi - lo - self.r - 4, 0)
        n_low = torch.minimum(ncl, max_acc)
        n_high = torch.minimum(nch, max_acc - n_low)
        trunc = (n_high > 0) & (n_high < nch)
        self.seg_lo = torch.where(trunc, hi - nch + n_high, self.seg_lo)
        self.seg_hi = torch.where(trunc, hi, self.seg_hi)
        self.lo = lo + n_low
        self.hi = hi - torch.where(trunc, nch, n_high)
        self.r = self.r + n_low + n_high
        self.rejl = self.rejl + n_low
        self.rejh = self.rejh + n_high
        return (n_low + n_high) > 0


def _count(work: Optional[dict], key: str, amount) -> None:
    """Add ``amount()`` to ``work[key]`` when work is being counted."""
    if work is not None:
        work[key] = work.get(key, 0) + int(amount())


def _sigma_or_mad(xs, s1, s2, nvalid, siglow, sighigh, use_mad, work):
    """SIGMA / MAD rejection (rejection_float.c:172-208)."""
    win = _Window(nvalid)
    median0 = _window_median(xs, win.lo, win.hi)
    dead = (median0 == 0.0) | (nvalid <= 1)
    active = ~dead
    med = median0
    first = True
    while True:
        def size(act=active, lo=win.lo, hi=win.hi):
            return torch.where(act, hi - lo, 0).sum()

        if use_mad:
            rows = _rows(xs)
            inwin = (rows >= win.lo) & (rows < win.hi)
            d = torch.where(inwin, torch.abs(xs - med), _INF)
            ds = torch.sort(d, dim=0).values
            spread = _window_median(ds, torch.zeros_like(win.lo),
                                    win.hi - win.lo)
            _count(work, "flops", lambda: 2 * size())
        else:
            _, spread = _window_mean_sd(s1, s2, win.lo, win.hi)
            _count(work, "flops", lambda: 3 * size())
        med_new = med if first else _window_median(xs, win.lo, win.hi)
        changed = win.clip(xs, med_new, spread, siglow, sighigh, active)
        _count(work, "flops", lambda: 4 * size())
        active = active & changed & ((win.hi - win.lo) > 3)
        med, first = med_new, False
        if not bool(changed.any()):
            break
    zero = torch.zeros_like(win.lo)
    win.lo = torch.where(dead, zero, win.lo)
    win.hi = torch.where(dead, zero, win.hi)
    win.seg_hi = torch.where(dead, zero, win.seg_hi)
    return win


def _percentile(xs, nvalid, plow, phigh):
    """PERCENTILE clipping (rejection_float.c:31-43): one pass against
    the median."""
    win = _Window(nvalid)
    med = _window_median(xs, win.lo, win.hi)
    dead = (med == 0.0) | (nvalid <= 1)
    inwin = _rows(xs) < nvalid
    n_low = (inwin & ((med - xs) > med * plow)).sum(0, dtype=torch.int32)
    n_high = (inwin & ((xs - med) > med * phigh)).sum(0, dtype=torch.int32)
    zero = torch.zeros_like(n_low)
    win.lo = torch.where(dead, zero, n_low)
    win.hi = torch.where(dead, zero, nvalid - n_high)
    win.rejl = torch.where(dead, zero, n_low)
    win.rejh = torch.where(dead, zero, n_high)
    return win


def _winsor_sd(xs, s1, s2, lo, hi, med, active, work, steps, capped):
    """Iterated winsorized σ — the exact C iteration
    (rejection_float.c:222-236): σ starts at the plain window sd, each
    step re-clips the ACCUMULATED w to med ± 1.5σ, σ ← 1.134·sd(w), and a
    pixel freezes once |σ−σ0| ≤ 5e-4·σ0.  Pixels whose clipping has
    stopped (not ``active``) start frozen: the clip round ignores their σ.

    The accumulated w is never stored.  The column is sorted and nested
    clamps compose, clamp(clamp(x, L, H), m0, m1) =
    clamp(x, clamp(L, m0, m1), clamp(H, m0, m1)), so w = clamp(xs, L, H)
    with (L, H) starting at (−∞, +∞) and clamped each step: the same
    values, selected without arithmetic.  ``steps`` (int32 per pixel)
    gains each pixel's σ steps; pixels still unsettled after
    ``WINSOR_MAX_STEPS`` steps are added to ``capped`` when it is given."""
    _, sigma = _window_mean_sd(s1, s2, lo, hi)
    rows = _rows(xs)
    inwin = (rows >= lo) & (rows < hi)
    n = torch.clamp_min((hi - lo).float(), 1.0)
    nm1 = torch.clamp_min(n - 1.0, 1.0)
    size = hi - lo
    low = torch.full_like(sigma, -_INF)
    high = torch.full_like(sigma, _INF)
    frozen = (size <= 1) | ~active
    for _ in range(WINSOR_MAX_STEPS):
        if bool(frozen.all()):
            break
        _count(work, "flops", lambda: 7 * torch.where(frozen, 0, size).sum())
        m0 = fma(-1.5, sigma, med)
        m1 = fma(1.5, sigma, med)
        low2 = torch.minimum(torch.maximum(low, m0), m1)
        high2 = torch.minimum(torch.maximum(high, m0), m1)
        w = torch.minimum(torch.maximum(xs, low2), high2)
        mean = _colsum(w, inwin) / n
        d = w - mean
        var = _colsum(d * d, inwin) / nm1
        new_sig = 1.134 * torch.sqrt(torch.clamp_min(var, 0.0))
        conv = torch.abs(new_sig - sigma) <= sigma * 5e-4
        low = torch.where(frozen, low, low2)
        high = torch.where(frozen, high, high2)
        sigma = torch.where(frozen, sigma, new_sig)
        steps += (~frozen).int()
        frozen = frozen | conv
    if capped is not None:
        capped += (~frozen).sum().to(capped)
    return sigma


def _winsorized(xs, s1, s2, nvalid, siglow, sighigh, work, capped):
    """WINSORIZED sigma clipping (rejection_float.c:222-257)."""
    win = _Window(nvalid)
    active = nvalid > 1
    steps = torch.zeros_like(nvalid)
    while True:
        med = _window_median(xs, win.lo, win.hi)
        sig = _winsor_sd(xs, s1, s2, win.lo, win.hi, med, active, work,
                         steps, capped)
        _count(work, "flops", lambda: 4 * torch.where(
            active, win.hi - win.lo, 0).sum())
        changed = win.clip(xs, med, sig, siglow, sighigh, active)
        active = active & changed & ((win.hi - win.lo) > 3)
        if not bool(changed.any()):
            break
    if work is not None:
        _count_steps(work, steps, "winsor", "steps")
    return win


def _count_steps(work: dict, steps: torch.Tensor, loop: str,
                 unit: str) -> None:
    """Steps of a per-pixel loop in a call (the winsorized σ steps, the
    SIGMEDIAN or LINEARFIT rounds), for reading a kernel's divergence:
    their sum (``{loop}_{unit}``), the most one pixel took
    (``{loop}_{unit}_max``), and over groups of 32 consecutive pixels (a
    warp, one pixel a lane) the sum of each group's most
    (``{loop}_warp_{unit}``) and the number of groups (``{loop}_warps``)."""
    groups = torch.nn.functional.pad(steps, (0, -steps.numel() % 32))
    _count(work, f"{loop}_{unit}", lambda: steps.sum())
    _count(work, f"{loop}_warp_{unit}",
           lambda: groups.reshape(-1, 32).amax(1).sum())
    _count(work, f"{loop}_warps", lambda: groups.numel() // 32)
    key = f"{loop}_{unit}_max"
    work[key] = max(work.get(key, 0),
                    int(steps.max()) if steps.numel() else 0)


def _sigmedian(xs, nvalid, siglow, sighigh, work, capped):
    """SIGMEDIAN (rejection_float.c:210-221): rejected values are replaced
    by the running median and the column is re-sorted, round after round,
    until a round replaces nothing; the kept count never shrinks.  Mean
    and sd are two-pass over the valid rows (pallas/reject_stack.py:
    478-519).  Pixels still replacing after ``SIGMEDIAN_MAX_ROUNDS`` rounds
    are added to ``capped`` when it is given; ``work`` gains the rounds
    each pixel ran (``_count_steps``, the last one that replaced nothing
    included).  Returns (values, rej_low, rej_high)."""
    rows = _rows(xs)
    vmask = rows < nvalid
    zero = torch.zeros_like(nvalid)
    nv = nvalid.float()
    nvs = torch.clamp_min(nv, 1.0)
    rejl, rejh = zero, zero
    active = nvalid > 1
    rounds = torch.zeros_like(nvalid)
    v = xs
    for _ in range(SIGMEDIAN_MAX_ROUNDS):
        if not bool(active.any()):
            break
        rounds += active.int()
        _count(work, "flops", lambda: 8 * torch.where(active, nvalid,
                                                      0).sum())
        _count(work, "compares", lambda: _sort_compares(
            torch.where(active, nvalid, 0)))
        med = _window_median(v, zero, nvalid)
        mean = _colsum(v, vmask) / nvs
        d = v - mean
        var = _colsum(d * d, vmask) / torch.clamp_min(nv - 1.0, 1.0)
        sd = torch.where(nv > 1, torch.sqrt(torch.clamp_min(var, 0.0)), 0.0)
        low = vmask & ((med - v) > sd * siglow) & active
        high = vmask & ((v - med) > sd * sighigh) & active
        rep = low | high
        v = torch.sort(torch.where(rep, med, v), dim=0).values
        rejl = rejl + low.sum(0, dtype=torch.int32)
        rejh = rejh + high.sum(0, dtype=torch.int32)
        active = active & rep.any(0)
    if capped is not None:
        capped += active.sum().to(capped)
    if work is not None:
        _count_steps(work, rounds, "sigmedian", "rounds")
    return v, rejl, rejh


def linearfit_constants(n_full: int) -> Tuple[float, float]:
    """(m_x, 1/m_dx2) of LINEARFIT for the FULL frame count, as float32
    values: the reference precomputes them once for nb_frames and keeps
    them after rejections shrink the set (median_and_mean.c:1491-1499;
    pallas/reject_stack.py:527-532)."""
    m_x = (n_full - 1) * 0.5
    run = 0.0
    for j in range(n_full):
        dx = j - m_x
        run += (dx * dx - run) / (j + 1)
    inv = 1.0 / run if run else 0.0
    f32 = torch.tensor([m_x, inv], dtype=torch.float32).tolist()
    return f32[0], f32[1]


def _linearfit(xs, nvalid, siglow, sighigh, n_full, work):
    """LINEARFIT (rejection_float.c:259-300): fit y = b + a·i over the
    sorted kept values (i = rank among the kept), σ = mean |residual|,
    clip; the cumulative N−r≤4 guard accepts candidates in row order.
    ``work`` gains the rounds each pixel ran (``_count_steps``).  Returns
    (keep mask over the sorted rows, rej_low, rej_high)."""
    m_x, inv_mdx2 = linearfit_constants(n_full)
    keep = _rows(xs) < nvalid
    zero = torch.zeros_like(nvalid)
    r, rejl, rejh = zero, zero, zero
    active = nvalid > 1
    rounds = torch.zeros_like(nvalid)
    while bool(active.any()):
        rounds += active.int()
        nk = keep.sum(0, dtype=torch.int32)
        _count(work, "flops", lambda: 16 * torch.where(active, nk, 0).sum())
        kf = keep.float()
        pos = torch.cumsum(kf, 0) - 1.0
        nks = torch.clamp_min(nk.float(), 1.0)
        m_y = _colsum(xs, keep) / nks
        m_dxdy = _colsum((pos - m_x) * (xs - m_y), keep) / nks
        a = m_dxdy * inv_mdx2
        b = fma(-m_x, a, m_y)
        resid = xs - fma(a, pos, b)
        sigma = _colsum(torch.abs(resid), keep) / nks
        low = keep & ((-resid) > sigma * siglow)
        high = keep & (resid > sigma * sighigh)
        cand = low | high
        max_acc = torch.clamp_min(nk - r - 4, 0)
        rank = torch.cumsum(cand.int(), 0)
        accept = cand & (rank <= max_acc) & active
        n_low = (accept & low).sum(0, dtype=torch.int32)
        n_high = (accept & high).sum(0, dtype=torch.int32)
        keep = keep & ~accept
        r = r + n_low + n_high
        rejl = rejl + n_low
        rejh = rejh + n_high
        changed = (n_low + n_high) > 0
        active = active & changed & ((nk - n_low - n_high) > 3)
    if work is not None:
        _count_steps(work, rounds, "linearfit", "rounds")
    return keep, rejl, rejh


def gesdt_critical_values(nb_frames: int, alpha: float,
                          max_outliers: int) -> "np.ndarray":
    """GESDT λ_j table (median_and_mean.c:1479-1486), float32, on the host
    through scipy's Student t quantile."""
    import numpy as np
    from scipy.stats import t as tdist

    crit = np.zeros(max(max_outliers, 1), dtype=np.float32)
    size = nb_frames
    for j in range(max_outliers):
        df = size - 2
        if df <= 0:
            crit[j] = np.inf
            continue
        tq = tdist.ppf(1.0 - alpha / (2.0 * size), df)
        crit[j] = (size - 1) * tq / (np.sqrt(size) *
                                     np.sqrt(size - 2 + tq * tq))
        size -= 1
    return crit


def gesdt_max_outliers(n: int, fraction: float) -> int:
    """The GESDT outlier budget: ⌊n · fraction⌋ (stacking.c)."""
    return int(math.floor(n * fraction))


def _select_at(xs, idx):
    """xs[idx[p], p] per pixel; an index past the last row reads 0."""
    N = xs.shape[0]
    v = xs.gather(0, torch.clamp(idx, 0, N - 1).long()[None])[0]
    return torch.where(idx < N, v, 0.0)


def _gesdt(xs, s1, s2, nvalid, critical, max_outliers, n_full, work):
    """GESDT (rejection_float.c:302-345 + confirm_outliers,
    median_and_mean.c:685-701).  Walk: each step takes the Grubbs
    statistic of the current sorted window and removes its farther end
    (the low end on a tie); afterwards every step up to the last flagged
    one (and at least step 1) is confirmed.  Two passes, as the Pallas
    kernel (pallas/reject_stack.py:586-662): the first finds the last
    flagged step, the second replays the walk.  A low removal rejects
    the true sorted index; a high one the shrunk-array index size−1
    (reference quirk, rejection_float.c:332).  Returns (keep, rej_low,
    rej_high)."""
    M = max(int(max_outliers), 1)
    crit = torch.as_tensor(critical, dtype=torch.float32,
                           device=xs.device).reshape(-1)[:M]
    zero = torch.zeros_like(nvalid)
    median0 = _window_median(xs, zero, nvalid)
    removed = n_full - nvalid
    budget_ok = removed < max_outliers

    def walk(j, lo, hi):
        size = hi - lo
        mean, sd = _window_mean_sd(s1, s2, lo, hi)
        first = _select_at(xs, lo)
        last = _select_at(xs, torch.clamp_min(hi - 1, 0))
        dev_low = mean - first
        dev_high = last - mean
        take_high = dev_high > dev_low
        g = torch.where(take_high, dev_high, dev_low) / \
            torch.clamp_min(sd, 1e-30)
        valid = (j < (max_outliers - removed)) & (size > 1)
        _count(work, "flops", lambda: 3 * torch.where(valid, size, 0).sum())
        new_lo = torch.where(valid & ~take_high, lo + 1, lo)
        new_hi = torch.where(valid & take_high, hi - 1, hi)
        return size, g, take_high, first, last, valid, new_lo, new_hi

    last_flag = torch.full_like(nvalid, -1)
    lo, hi = zero, nvalid
    for j in range(M):
        size, g, _, _, _, valid, lo, hi = walk(j, lo, hi)
        crit_j = crit[torch.clamp_max(removed + j, M - 1).long()]
        flagged = (g > crit_j) & (size > 2) & valid
        last_flag = torch.where(flagged, j, last_flag)
    i_conf = torch.clamp_min(last_flag, min(1, M - 1))

    rows = _rows(xs)
    keep = rows < nvalid
    rejl, rejh = zero, zero
    lo, hi = zero, nvalid
    for j in range(M):
        size, _, take_high, first, last, valid, new_lo, new_hi = \
            walk(j, lo, hi)
        conf = (j <= i_conf) & valid & budget_ok
        is_high = torch.where(take_high, last, first) >= median0
        rejl = rejl + (conf & ~is_high).int()
        rejh = rejh + (conf & is_high).int()
        rec = torch.where(take_high, size - 1, lo)
        keep = keep & ~((rows == rec) & conf)
        lo, hi = new_lo, new_hi
    return keep, rejl, rejh


def _sort_compares(nvalid: torch.Tensor) -> int:
    """Comparisons a comparison sort needs for each pixel's valid values:
    ⌈log₂(n!)⌉, the information-theoretic least, summed over pixels."""
    n = nvalid.double()
    return int(torch.ceil(torch.lgamma(n + 1.0) / math.log(2.0)
                          - 1e-9).clamp_min(0).sum())


def _weighted_mean(x, weights, keep, values, nkept):
    """The weighted mean (median_and_mean.c:1041-1095): the kept values'
    range [pmin, pmax] selects entries of the ORIGINAL (unsorted)
    normalized values x, zeros excluded, and their weights; a zero Σw or
    Σx·w falls back to Σ(x > 0 in range) / nkept."""
    pmin = torch.where(keep, values, _INF).amin(0)
    pmax = torch.where(keep, values, -_INF).amax(0)
    inrange = (x >= pmin) & (x <= pmax) & (x != 0.0)
    w = weights.expand_as(x)
    wsum = _colsum(x * w, inrange)
    wnorm = _colsum(w, inrange)
    fallback = _colsum(x, inrange & (x > 0.0)) / torch.clamp_min(nkept, 1.0)
    return torch.where((wnorm != 0.0) & (wsum != 0.0), wsum / wnorm,
                       fallback)


def rejection_mean(stack: torch.Tensor, rtype: int, siglow: float,
                   sighigh: float, weights: Optional[torch.Tensor] = None,
                   critical=None, n_full: int = 0, max_outliers: int = 0,
                   work: Optional[dict] = None,
                   capped: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Reject + mean one tile.  ``stack``: (N, P) float32 normalized frame
    values.  Returns (mean f32, rej_low i32, rej_high i32), each (P,).

    Zero and non-finite entries are not data (rejection_float.c:115-136).
    A pixel with nothing kept takes the median of its whole column with
    those entries counted as zeros.  ``weights`` ((N, P), or (N, 1) per
    frame) turns the mean into the reference's weighted mean.  GESDT
    takes its λ table (``critical``) and outlier budget; LINEARFIT and
    GESDT take the full frame count ``n_full`` (default N).  ``work``,
    when given, accumulates the float operations the data needed
    (``flops``) and the least number of sort comparisons (``compares``),
    for the roofline bound of the kernel, and the steps of the winsorized
    σ iteration and the SIGMEDIAN and LINEARFIT rounds
    (``_count_steps``).  ``capped``, an int64 scalar tensor, gains the
    pixels whose loop stopped at its bound: SIGMEDIAN's
    ``SIGMEDIAN_MAX_ROUNDS`` or the winsorized ``WINSOR_MAX_STEPS``."""
    check_rtype(rtype)
    N, P = stack.shape
    n_full = n_full or N
    valid = (stack != 0.0) & torch.isfinite(stack)
    nvalid = valid.sum(0, dtype=torch.int32)
    xs = torch.sort(torch.where(valid, stack, _INF), dim=0).values
    s1 = torch.where(torch.isfinite(xs), xs, 0.0)
    s2 = s1 * s1
    _count(work, "compares", lambda: _sort_compares(nvalid))
    rows = _rows(xs)
    zero = torch.zeros_like(nvalid)
    values = s1

    if rtype in WINDOW_MODES:
        if rtype == NO_REJEC:
            win = _Window(nvalid)
        elif rtype == PERCENTILE:
            win = _percentile(xs, nvalid, siglow, sighigh)
        elif rtype in (SIGMA, MAD):
            win = _sigma_or_mad(xs, s1, s2, nvalid, siglow, sighigh,
                                rtype == MAD, work)
        else:
            win = _winsorized(xs, s1, s2, nvalid, siglow, sighigh, work,
                              capped)
        keep = ((rows >= win.lo) & (rows < win.hi)) | \
            ((rows >= win.seg_lo) & (rows < win.seg_hi))
        rejl, rejh = win.rejl, win.rejh
    elif rtype == SIGMEDIAN:
        v, rejl, rejh = _sigmedian(xs, nvalid, siglow, sighigh, work,
                                   capped)
        values = torch.where(torch.isfinite(v), v, 0.0)
        keep = rows < nvalid
    elif rtype == LINEARFIT:
        keep, rejl, rejh = _linearfit(xs, nvalid, siglow, sighigh, n_full,
                                      work)
    else:
        keep, rejl, rejh = _gesdt(xs, s1, s2, nvalid, critical,
                                  max_outliers, n_full, work)

    # kept ≤ 1 before rejection → keep as is (rejection_float.c:141)
    trivial = nvalid <= 1
    keep = torch.where(trivial, rows < nvalid, keep)
    nkept = keep.sum(0).float()
    mean = _colsum(values, keep) / torch.clamp_min(nkept, 1.0)
    _count(work, "flops", lambda: nkept.sum())

    # nothing kept → median of the column, invalid entries as zeros
    allv = torch.sort(torch.where(valid, stack, 0.0), dim=0).values
    med_all = 0.5 * (allv[(N - 1) // 2] + allv[N // 2])
    if weights is not None:
        mean = _weighted_mean(stack, weights, keep, values, nkept)
        _count(work, "flops", lambda: 5 * N * P)
    mean = torch.where(nkept > 0, mean, med_all)
    return (mean, torch.where(trivial, zero, rejl),
            torch.where(trivial, zero, rejh))
