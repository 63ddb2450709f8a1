"""Milliseconds a frame of detection's host finish: the self time of the
program's span ``fused.detect.finish`` (the fits' fetch, the blended
refits, the filters and the dedup), summed over the window's sessions;
nothing where the cell does not register or the program keeps no span
record."""

from benchmark.metrics import _record


def read(run):
    return _record.span_ms_per_frame(run, "fused.detect.finish", own=True)
