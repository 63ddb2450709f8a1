"""Milliseconds a frame of the fused stage ``calibrate``, summed over the
window's sessions (the program's stage clock, each stage ended by a
device synchronize)."""


def read(run):
    return run.stage_ms_per_frame("calibrate")
