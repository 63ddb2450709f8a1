"""Percent of a session in which no operation ran on the device: 100
less the profiled session's device busy time (the union of its kernels,
copies and sets) over the window's mean session wall.  The profiler's
own host cost stretches the profiled session's span; over that span the
share would count the profiler's time as the device's idle time."""


def read(run):
    t, wall = run.trace, run.mean_wall()
    if t is None or not wall:
        return None
    return 100.0 * (1.0 - t.busy_s / wall)
