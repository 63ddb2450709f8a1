"""What the check reads from a finished ``fusedstack`` session, as plain
data."""

from __future__ import annotations

import os

import numpy as np


def read(ctx, workdir: str, traffic: dict) -> dict:
    """The stacked image's path, the rejected totals (low, high), and with
    registration each frame's shift (dx, dy) frame → reference from the
    sequence's registration data (NaN for a frame left unregistered)."""
    out = {"image": os.path.join(workdir, traffic["output"]),
           "rejected": tuple(int(v) for v in ctx.result.total_rejected)}
    if traffic["check_args"]["register"]:
        reg = ctx.sequence.reg(0)
        sh = np.asarray(reg.H, np.float64)[:, :2, 2].copy()
        sh[~np.asarray(reg.valid, bool)] = np.nan
        out["shifts"] = sh
    return out
