"""Seconds a session of the result's write: the program's span
``cli.write`` (the stacked float32 FITS), the mean over the window's
sessions; nothing where the program keeps no span record."""

from benchmark.metrics import _record


def read(run):
    return _record.span_mean_s(run, "cli.write")
