"""Timing and tracing — counterpart of ``siril_tpu/utils/trace.py``
(``stage``:80, ``timings``:104, ``report``:111, ``reset``:122, the stall
monitor :39-77, ``start_device_trace``:127, ``stop_device_trace``:141,
``maybe_trace_env``:152).

Two layers:

- ``stage(name)``: the wall seconds of a pipeline stage, accumulated in
  a process-wide registry (``timings``, ``report``, ``reset``).  One
  shared daemon thread logs a heartbeat to stderr for any stage running
  past ``SIRIL_TPU_STALL_LOG_S`` seconds (90; 0 disables).  Each stage
  also opens a ``torch.profiler.record_function`` of the same name, so a
  device trace shows it as a span.  A stage adds no device
  synchronization: its seconds are the host's.
- The device trace: ``SIRIL_TPU_TRACE=<dir>`` (or ``start_device_trace``)
  records a ``torch.profiler`` trace with CPU and (on a card) CUDA
  activities; ``stop_device_trace`` writes it as a Chrome / Perfetto
  trace (``trace_<pid>.json``) and returns its path.  ``busy_share``
  reads such a file: the union of the CUDA kernels' spans over the traced
  window, and the kernels' names.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time
from collections import defaultdict
from contextlib import contextmanager
from typing import Dict, Iterator, List, Optional, Tuple

_lock = threading.Lock()
_acc: Dict[str, List[float]] = defaultdict(list)
_profiler = None
_trace_dir: Optional[str] = None

_STALL_S = float(os.environ.get("SIRIL_TPU_STALL_LOG_S", "90"))

_active: Dict[int, list] = {}       # key -> [name, t0, beats emitted]
_next_key = 0
_monitor_on = False


def _monitor() -> None:
    """One shared daemon thread heartbeats every stale active stage."""
    while True:
        time.sleep(5.0)
        now = time.perf_counter()
        with _lock:
            items = list(_active.items())
        for key, rec in items:
            name, t0, beats = rec
            k = int((now - t0) // _STALL_S)
            if k > beats:
                rec[2] = k
                # stderr: stdout may carry the -p pipe's line protocol
                print(f"[stall] stage '{name}' still running after "
                      f"{k * _STALL_S:.0f}s", file=sys.stderr, flush=True)


def _register(name: str) -> int:
    global _next_key, _monitor_on
    with _lock:
        key = _next_key
        _next_key += 1
        _active[key] = [name, time.perf_counter(), 0]
        if not _monitor_on:
            _monitor_on = True
            threading.Thread(target=_monitor, daemon=True).start()
    return key


@contextmanager
def stage(name: str) -> Iterator[None]:
    """Time one pipeline stage (accumulated), as a profiler span too."""
    from torch.profiler import record_function

    t0 = time.perf_counter()
    key = _register(name) if _STALL_S > 0 else None
    try:
        with record_function(name):
            yield
    finally:
        if key is not None:
            with _lock:
                _active.pop(key, None)
        dt = time.perf_counter() - t0
        with _lock:
            _acc[name].append(dt)


def timings() -> Dict[str, Tuple[int, float, float]]:
    """{stage: (calls, total_s, mean_s)}."""
    with _lock:
        return {k: (len(v), sum(v), sum(v) / len(v))
                for k, v in _acc.items() if v}


def report() -> str:
    rows = sorted(timings().items(), key=lambda kv: -kv[1][1])
    if not rows:
        return "no stage timings recorded"
    width = max(len(k) for k, _ in rows)
    lines = [f"{'stage':<{width}}  calls   total s    mean s"]
    for k, (n, tot, mean) in rows:
        lines.append(f"{k:<{width}}  {n:5d}  {tot:8.3f}  {mean:8.4f}")
    return "\n".join(lines)


def reset() -> None:
    with _lock:
        _acc.clear()


def start_device_trace(logdir: Optional[str] = None) -> bool:
    """Begin a ``torch.profiler`` trace (CPU, and CUDA where a card is)
    to be written into ``logdir`` (default: $SIRIL_TPU_TRACE)."""
    global _profiler, _trace_dir
    logdir = logdir or os.environ.get("SIRIL_TPU_TRACE")
    if not logdir or _profiler is not None:
        return False
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    _profiler = profile(activities=acts)
    _profiler.start()
    _trace_dir = logdir
    return True


def stop_device_trace() -> Optional[str]:
    """End the trace and write it as a Chrome / Perfetto JSON file; its
    path, or None when no trace ran."""
    global _profiler, _trace_dir
    if _profiler is None:
        return None
    prof, d = _profiler, _trace_dir
    _profiler, _trace_dir = None, None
    prof.stop()
    path = os.path.join(d, f"trace_{os.getpid()}.json")
    prof.export_chrome_trace(path)
    return path


def maybe_trace_env() -> None:
    """Start a device trace if SIRIL_TPU_TRACE is set (the CLI's entry
    calls it, so any run can be traced without code changes)."""
    if os.environ.get("SIRIL_TPU_TRACE"):
        start_device_trace()


def busy_share(trace_path: str) -> dict:
    """The device's busy share in a Chrome trace written by
    ``stop_device_trace``: the union of its CUDA kernels' spans over the
    traced window (from the first event's start to the last one's end),
    and the kernels' names with their counts."""
    with open(trace_path) as f:
        doc = json.load(f)
    events = doc["traceEvents"] if isinstance(doc, dict) else doc
    spans, names, lo, hi = [], defaultdict(int), None, None
    for e in events:
        if e.get("ph") != "X" or "ts" not in e:
            continue
        t0 = float(e["ts"])
        t1 = t0 + float(e.get("dur", 0.0))
        lo = t0 if lo is None else min(lo, t0)
        hi = t1 if hi is None else max(hi, t1)
        if e.get("cat") == "kernel":
            spans.append((t0, t1))
            names[e.get("name", "")] += 1
    busy, end = 0.0, None
    for t0, t1 in sorted(spans):
        if end is None or t0 > end:
            busy += t1 - t0
            end = t1
        elif t1 > end:
            busy += t1 - end
            end = t1
    window = (hi - lo) if lo is not None else 0.0
    return dict(busy_s=busy * 1e-6, window_s=window * 1e-6,
                share=busy / window if window > 0 else 0.0,
                kernels=dict(names))
