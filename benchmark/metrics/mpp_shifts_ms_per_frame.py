"""Milliseconds a frame of ``mpp``'s stage ``shifts`` (the alignment
points' multilevel correlation), summed over the window's sessions."""


def read(run):
    return run.stage_ms_per_frame("shifts")
