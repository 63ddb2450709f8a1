"""Percent of detection in which the device works: in the profiled
session, the union of its kernels, copies and sets within the program's
``fused.detect`` spans, over those spans' summed length.

The spans come from the profiled session's own span record, on the
profiler's clock; the device operations are relative to the harness's
session span, which closes as the record's root span (``cli.command``)
closes, but for the calls that return from the command.  So the
session span's start is taken as the root's end less the span's length:
late by those calls, about a millisecond under the profiler, against
seconds of detection.  Nothing where the cell does not register or the
program keeps no span record."""

from benchmark.metrics import _record, _spans


def read(run):
    t, s = run.trace, run.traced
    if t is None or s is None:
        return None
    found = _record.entries([s])
    if not found:
        return None
    events = found[0][1].get("events", ())
    roots = [e for e in events if e[1] < 0]
    detect = [(a, b) for name, _, a, b in events if name == "fused.detect"]
    if not roots or not detect:
        return None
    end = roots[0][3]

    def rel(ns):                        # seconds from the session's start
        return (ns - end) * 1e-9 + t.window_s

    ops = [(a, b) for _, _, a, b in t.device_ops]
    busy = length = 0.0
    for a, b in detect:
        busy += _spans.busy_seconds(ops, rel(a), rel(b))
        length += (b - a) * 1e-9
    return 100.0 * busy / length if length > 0 else None
