"""Seconds a session of the dark's deviant map (the cosmetic correction's
hot and cold pixels, found on the host, and their plan): the program's
span ``fused.masters.deviant``, the mean over the window's sessions;
nothing where the cell has no dark or the program keeps no span
record."""

from benchmark.metrics import _record


def read(run):
    return _record.span_mean_s(run, "fused.masters.deviant")
