"""Timing and tracing — counterpart of ``siril_tpu/utils/trace.py``
(``stage``:80, ``timings``:104, ``report``:111, ``reset``:122, the stall
monitor :39-77, ``start_device_trace``:127, ``stop_device_trace``:141,
``maybe_trace_env``:152).

Three layers:

- ``stage(name)``: the wall seconds of a pipeline stage, added to a
  process-wide count and total a name (``timings``, ``report``,
  ``reset``).  One shared daemon thread logs a heartbeat to stderr for
  any stage running past ``SIRIL_TPU_STALL_LOG_S`` seconds (90; 0
  disables).  While a ``torch.profiler`` runs, each stage also opens a
  ``record_function`` of the same name, so a device trace shows it as a
  span.  A stage adds no device synchronization: its seconds are the
  host's.
- The command's record: ``command()`` (opened by the CLI round each
  command it logs) records every stage entered on its thread while it is
  open — its name, the index of its parent span, its start and its end —
  and the counters that ``count(name, n)`` adds from any thread.  Starts
  and ends are ``time.perf_counter_ns`` readings moved, by one anchor
  pair taken when this module is imported, onto the clock of the
  profiler's events (Unix nanoseconds), so a span of the record and its
  own ``record_function`` event in a profile share one clock.  Closed,
  the record gives ``spans`` ({name: [calls, total_s, self_s]}, self
  time being the span's duration less what its child spans cover),
  ``counters`` ({name: int}) and ``events`` (name, parent index, start
  ns, end ns), at most ``EVENTS_CAP`` a command (the counter
  ``trace.events_dropped`` counts the rest).  ``keep`` holds the log
  entries of the process's last ``RECENT`` commands (``recent``) for a
  reader that outlives the session object; of these only the newest
  keeps its ``events``.
- The device trace: ``SIRIL_TPU_TRACE=<dir>`` (or ``start_device_trace``)
  records a ``torch.profiler`` trace with CPU and (on a card) CUDA
  activities; ``stop_device_trace`` writes it as a Chrome / Perfetto
  trace (``trace_<pid>.json``) and returns its path.  ``busy_share``
  reads such a file: the union (``merged``) of the device's kernels,
  copies and sets within the trace's ``cli.command`` spans (or, where no
  command was logged, the whole trace), and the kernels' names.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time
from collections import defaultdict, deque
from contextlib import contextmanager
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

_lock = threading.Lock()
_acc: Dict[str, List[float]] = {}        # name -> [calls, total_s]
_profiler = None
_trace_dir: Optional[str] = None

_STALL_S = float(os.environ.get("SIRIL_TPU_STALL_LOG_S", "90"))

_active: Dict[int, list] = {}       # key -> [name, t0, beats emitted]
_next_key = 0
_monitor_on = False

#: raw span events a command's record keeps
EVENTS_CAP = 4096
#: log entries of the last commands that ``keep`` holds
RECENT = 512
ROOT_SPAN = "cli.command"

_now = time.perf_counter_ns
#: perf_counter_ns + this = the profiler's clock (Unix ns)
_ANCHOR_NS = time.time_ns() - time.perf_counter_ns()
_record: Optional["_Record"] = None
_recent: deque = deque(maxlen=RECENT)


def _profiling() -> bool:
    import torch

    return torch._C._autograd._profiler_enabled()


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


class _Record:
    """The spans and counters of one command (see the module's text)."""

    def __init__(self) -> None:
        self.thread = threading.get_ident()
        self.events: List[list] = []         # [name, parent, t0, t1] ns
        self.open: List[list] = []    # [event index, t0, child ns, name]
        self.spans: Dict[str, List[int]] = {}   # [calls, total, self] ns
        self.counters: Dict[str, int] = {}

    def enter(self, name: str, t0: int) -> list:
        parent = self.open[-1][0] if self.open else -1
        if len(self.events) < EVENTS_CAP:
            idx = len(self.events)
            self.events.append([name, parent, t0 + _ANCHOR_NS, None])
        else:
            idx = -1
            self.counters["trace.events_dropped"] = \
                self.counters.get("trace.events_dropped", 0) + 1
        frame = [idx, t0, 0, name]
        self.open.append(frame)
        return frame

    def exit(self, frame: list, t1: int) -> None:
        idx, t0, child, name = frame
        for i in range(len(self.open) - 1, -1, -1):
            if self.open[i] is frame:
                del self.open[i]
                break
        dur = t1 - t0
        if self.open:
            self.open[-1][2] += dur
        s = self.spans.get(name)
        if s is None:
            self.spans[name] = [1, dur, dur - child]
        else:
            s[0] += 1
            s[1] += dur
            s[2] += dur - child
        if idx >= 0:
            self.events[idx][3] = t1 + _ANCHOR_NS

    def result(self) -> dict:
        """``spans``, ``counters`` and ``events`` of the closed record."""
        return dict(
            spans={k: [n, tot * 1e-9, own * 1e-9]
                   for k, (n, tot, own) in self.spans.items()},
            counters=dict(self.counters),
            events=[tuple(e) for e in self.events if e[3] is not None])


class stage:
    """Time one pipeline stage (accumulated), a span of the open
    command's record and, while a profiler runs, a profiler span too;
    ``seconds`` is its duration once closed."""

    __slots__ = ("name", "t0", "t1", "_key", "_frame", "_rec", "_rf")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self) -> "stage":
        self._key = _register(self.name) if _STALL_S > 0 else None
        rec = _record
        self._rec = rec if rec is not None and \
            rec.thread == threading.get_ident() else None
        self._rf = None
        if _profiling():
            from torch.profiler import record_function

            self._rf = record_function(self.name)
        self.t0 = t0 = _now()
        if self._rec is not None:
            self._frame = self._rec.enter(self.name, t0)
        if self._rf is not None:
            self._rf.__enter__()
        return self

    def __exit__(self, *exc) -> bool:
        if self._rf is not None:
            self._rf.__exit__(*exc)
        self.t1 = t1 = _now()
        if self._rec is not None:
            self._rec.exit(self._frame, t1)
        with _lock:
            if self._key is not None:
                _active.pop(self._key, None)
            a = _acc.get(self.name)
            if a is None:
                _acc[self.name] = [1, (t1 - self.t0) * 1e-9]
            else:
                a[0] += 1
                a[1] += (t1 - self.t0) * 1e-9
        return False

    @property
    def seconds(self) -> float:
        return (self.t1 - self.t0) * 1e-9


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` of the open command's record
    (from any thread); nothing where no command is open."""
    rec = _record
    if rec is None:
        return
    with _lock:
        rec.counters[name] = rec.counters.get(name, 0) + int(n)


@contextmanager
def command() -> Iterator[_Record]:
    """Open a command's record, its root span ``cli.command`` round the
    block; ``result()`` of the yielded record reads it once the block
    ends.  A record opened inside another keeps the inner command's spans
    and counters apart, and hands the outer one back when it closes."""
    global _record
    prev, rec = _record, _Record()
    _record = rec
    try:
        with stage(ROOT_SPAN):
            yield rec
    finally:
        _record = prev


def keep(entry: dict) -> None:
    """Hold a command's log entry among the process's last ``RECENT``;
    the entry held before it is replaced by a copy without ``events``."""
    with _lock:
        if _recent and "events" in _recent[-1]:
            _recent[-1] = {k: v for k, v in _recent[-1].items()
                           if k != "events"}
        _recent.append(entry)


def recent() -> List[dict]:
    """The log entries ``keep`` holds, oldest first."""
    with _lock:
        return list(_recent)


def timings() -> Dict[str, Tuple[int, float, float]]:
    """{stage: (calls, total_s, mean_s)}."""
    with _lock:
        return {k: (int(n), tot, tot / n) for k, (n, tot) in _acc.items()
                if n}


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


#: Chrome-trace categories of the device's own work
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def merged(spans: Sequence[Tuple[float, float]], lo: float = -float("inf"),
           hi: float = float("inf")) -> List[Tuple[float, float]]:
    """The union of ``spans`` clipped to [lo, hi], as disjoint sorted
    spans."""
    out: List[Tuple[float, float]] = []
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


def busy_share(trace_path: str) -> dict:
    """The device's busy share in a Chrome trace written by
    ``stop_device_trace``: the union of its kernels', copies' and sets'
    spans within the window — the union of the trace's ``cli.command``
    spans, or where no command was logged the first event's start to the
    last one's end — and the kernels' names with their counts."""
    with open(trace_path) as f:
        doc = json.load(f)
    events = doc["traceEvents"] if isinstance(doc, dict) else doc
    spans, cmds, names = [], [], defaultdict(int)
    lo = hi = None
    for e in events:
        if e.get("ph") != "X" or "ts" not in e:
            continue
        t0 = float(e["ts"])
        t1 = t0 + float(e.get("dur", 0.0))
        lo = t0 if lo is None else min(lo, t0)
        hi = t1 if hi is None else max(hi, t1)
        cat = e.get("cat")
        if cat in DEVICE_CATS:
            spans.append((t0, t1))
            if cat == "kernel":
                names[e.get("name", "")] += 1
        elif cat == "user_annotation" and e.get("name") == ROOT_SPAN:
            cmds.append((t0, t1))
    windows = merged(cmds) or ([(lo, hi)] if lo is not None else [])
    busy = sum(t1 - t0 for w0, w1 in windows
               for t0, t1 in merged(spans, w0, w1))
    window = sum(w1 - w0 for w0, w1 in windows)
    return dict(busy_s=busy * 1e-6, window_s=window * 1e-6,
                share=busy / window if window > 0 else 0.0,
                kernels=dict(names))
