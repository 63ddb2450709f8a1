"""One session under ``torch.profiler``, read in memory.

The traced run profiles a single session after the measured window, so
the trace holds one session's events and the window's numbers carry no
profiler cost.  From the profiler's events come the device operations
(kernels, copies and sets), the session's own span (a
``record_function`` the harness puts round it), the program's stage
spans (its ``record_function`` names, such as ``fused.detect``) and the
host operations, which name the longest idle gaps."""

from __future__ import annotations

import bisect
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

from benchmark.metrics import _spans

SESSION_SPAN = "bench.session"
DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")


@dataclass
class Trace:
    window_s: float
    busy_s: float
    #: (name, kind, start s, end s) of each device operation, session-relative
    device_ops: List[Tuple[str, str, float, float]]
    #: seconds a name: device operations, summed
    op_seconds: Dict[str, float] = field(default_factory=dict)
    #: (name, seconds) of the longest idle gaps, named by what the host ran
    idle_gaps: List[Tuple[str, float]] = field(default_factory=list)

    def kernels(self):
        return [op for op in self.device_ops if op[1] == "kernel"]


def _kind(e) -> str:
    """The event's kind, from its device, its annotation flag and its
    name: ``kernel``, ``gpu_memcpy``, ``gpu_memset``, ``user_annotation``,
    ``gpu_user_annotation`` or ``cpu_op``."""
    on_device = not str(e.device_type()).endswith("CPU")
    if e.is_user_annotation():
        return "gpu_user_annotation" if on_device else "user_annotation"
    if not on_device:
        return "cpu_op"
    name = e.name()
    if name.startswith("Memcpy"):
        return "gpu_memcpy"
    if name.startswith("Memset"):
        return "gpu_memset"
    return "kernel"


def read_events(events) -> Trace:
    """A ``Trace`` from a profiler's kineto events (the events of
    ``prof.profiler.kineto_results.events()``)."""
    dev_ops, annotations, host = [], [], []
    lo = hi = None
    for e in events:
        kind = _kind(e)
        t0 = e.start_ns() * 1e-9
        t1 = t0 + e.duration_ns() * 1e-9
        name = e.name()
        if kind in DEVICE_KINDS:
            dev_ops.append((name, kind, t0, t1))
        elif kind == "user_annotation":
            if name == SESSION_SPAN:
                lo, hi = t0, t1
            else:
                annotations.append((name, t0, t1))
        elif kind == "cpu_op":
            host.append((t0, t1, name))
    if lo is None:
        raise RuntimeError(f"no {SESSION_SPAN!r} span in the trace")
    spans = [(a, b) for _, _, a, b in dev_ops]
    busy = _spans.busy_seconds(spans, lo, hi)
    op_s: Dict[str, float] = defaultdict(float)
    for name, _, a, b in dev_ops:
        op_s[name] += b - a
    named = [(_name_gap(g, annotations, host), g[1] - g[0])
             for g in _spans.gaps(spans, lo, hi)[:10]]
    ops = [(n, k, a - lo, b - lo) for n, k, a, b in dev_ops
           if b > lo and a < hi]
    return Trace(hi - lo, busy, ops, dict(op_s), named)


def _innermost(spans, t):
    best = None
    for name, a, b in spans:
        if a <= t <= b and (best is None or b - a < best[2] - best[1]):
            best = (name, a, b)
    return best[0] if best else None


def _name_gap(gap, annotations, host) -> str:
    """The innermost program stage round the gap's middle, and the host
    operation running there (top-level: the longest one covering it)."""
    t = 0.5 * (gap[0] + gap[1])
    stage = _innermost(annotations, t) or SESSION_SPAN
    i = bisect.bisect_right(host, (t, float("inf"), ""))
    op = None
    for a, b, name in host[max(0, i - 2000):i]:
        if a <= t <= b and (op is None or b - a > op[1] - op[0]):
            op = (a, b, name)
    return f"{stage} / {op[2]}" if op else f"{stage} / host"


def profile_session(fn):
    """Run ``fn()`` under the profiler with CPU and CUDA activities; return
    (its result, the ``Trace``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        with record_function(SESSION_SPAN):
            out = fn()
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    host = sorted(prof.profiler.kineto_results.events(),
                  key=lambda e: e.start_ns())
    return out, read_events(host)
