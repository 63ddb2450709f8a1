"""Milliseconds a frame of the fused stage ``detect``, summed over the
window's sessions (the program's stage clock, each stage ended by a
device synchronize); nothing where the cell does not register."""


def read(run):
    return run.stage_ms_per_frame("detect")
