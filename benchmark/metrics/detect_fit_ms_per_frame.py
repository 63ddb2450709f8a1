"""Milliseconds a frame of the batched PSF fit of detection: the self
time of the program's span ``fused.detect.fit`` (the LM fit's enqueue on
the host, once a frame), summed over the window's sessions; nothing
where the cell does not register or the program keeps no span record."""

from benchmark.metrics import _record


def read(run):
    return _record.span_ms_per_frame(run, "fused.detect.fit", own=True)
