"""The program's own span record of a run's sessions.

For each command it logs, the program keeps a span record beside the
command's stages (``Session.command_log[-1]``: ``spans``, {name: [calls,
total s, self s]}; ``counters``, {name: int}; ``events``, (name, parent
index, start ns, end ns) on the profiler's clock), and it holds the log
entries of its last commands (``siril_tpu_torch.utils.trace.recent``).
A session of the run is the held entry whose stage seconds are the
session's own, float for float: the harness copies them from that
entry.  Where the program no longer holds the entry of every session
asked for, the readers read nothing rather than a part of the window;
so does a program without the record, which holds no such entries."""

from __future__ import annotations

from typing import List, Optional, Tuple


def entries(sessions) -> List[Tuple[object, dict]]:
    """(session, the program's log entry) for each of ``sessions``, in
    their order; empty unless the program still holds every one's
    entry."""
    try:
        from siril_tpu_torch.utils import trace
    except ImportError:
        return []
    recent = getattr(trace, "recent", None)
    if recent is None:
        return []
    held = [e for e in recent() if "spans" in e and e.get("stages")]
    out = []
    for s in sessions:
        e = next((e for e in reversed(held) if e["stages"] == s.stages),
                 None) if s.stages else None
        if e is None:
            return []
        out.append((s, e))
    return out


def _with(run, key: str, name: str):
    return [(s, e[key][name]) for s, e in entries(run.sessions)
            if name in e.get(key, {})]


def span_ms_per_frame(run, name: str, own: bool = False) -> Optional[float]:
    """Milliseconds a frame of span ``name`` (its self time with ``own``),
    summed over the window's sessions that ran it."""
    have = _with(run, "spans", name)
    frames = sum(s.frames for s, _ in have)
    if not frames:
        return None
    return 1e3 * sum(v[2 if own else 1] for _, v in have) / frames


def span_mean_s(run, name: str) -> Optional[float]:
    """Seconds a session of span ``name``, the mean over the window's
    sessions that ran it."""
    have = _with(run, "spans", name)
    return sum(v[1] for _, v in have) / len(have) if have else None


def counter_total(run, name: str) -> Tuple[Optional[int], int]:
    """Counter ``name`` summed over the window's sessions that counted it,
    and those sessions' frames; (None, 0) where none did."""
    have = _with(run, "counters", name)
    if not have:
        return None, 0
    return sum(v for _, v in have), sum(s.frames for s, _ in have)
