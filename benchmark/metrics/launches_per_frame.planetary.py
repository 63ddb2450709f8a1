"""Kernel launches a frame: the device's kernel events in the profiled
session over its frames."""


def read(run):
    t, s = run.trace, run.traced
    if t is None or s is None or not s.frames:
        return None
    return len(t.kernels()) / s.frames
