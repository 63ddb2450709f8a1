"""Frames read from disk a frame stacked: the program's counter
``io.frames_read`` (every frame its sequence reads) over the session's
input frames, summed over the window's sessions; above 1 where a frame
is read again.  Nothing where the program keeps no span record."""

from benchmark.metrics import _record


def read(run):
    reads, frames = _record.counter_total(run, "io.frames_read")
    return reads / frames if reads is not None and frames else None
