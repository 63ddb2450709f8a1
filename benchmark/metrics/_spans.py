"""Arithmetic on spans of a device trace: the union of the device's
operation spans within a window (the busy time), and the idle gaps
between them.  The union is the arithmetic of the program's
``utils/trace.busy_share``, copied, but taken over a window given by the
caller (one session's own span) rather than the trace's first and last
event of any kind."""

from __future__ import annotations

from typing import List, Sequence, Tuple

Span = Tuple[float, float]


def merged(spans: Sequence[Span], lo: float, hi: float) -> List[Span]:
    """The union of ``spans`` clipped to [lo, hi], as disjoint sorted
    spans."""
    out: List[Span] = []
    for t0, t1 in sorted(spans):
        t0, t1 = max(t0, lo), min(t1, hi)
        if t1 <= t0:
            continue
        if out and t0 <= out[-1][1]:
            if t1 > out[-1][1]:
                out[-1] = (out[-1][0], t1)
        else:
            out.append((t0, t1))
    return out


def busy_seconds(spans: Sequence[Span], lo: float, hi: float) -> float:
    """Length of the union of ``spans`` within [lo, hi]."""
    return sum(t1 - t0 for t0, t1 in merged(spans, lo, hi))


def gaps(spans: Sequence[Span], lo: float, hi: float) -> List[Span]:
    """The idle spans of [lo, hi] that no span covers, longest first."""
    out, t = [], lo
    for t0, t1 in merged(spans, lo, hi):
        if t0 > t:
            out.append((t, t0))
        t = t1
    if hi > t:
        out.append((t, hi))
    return sorted(out, key=lambda g: g[0] - g[1])
