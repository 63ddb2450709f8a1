"""Seconds a session of the command's load: the program's span
``cli.load`` (the sequence, the masters' files and the sample light),
the mean over the window's sessions; nothing where the program keeps no
span record."""

from benchmark.metrics import _record


def read(run):
    return _record.span_mean_s(run, "cli.load")
