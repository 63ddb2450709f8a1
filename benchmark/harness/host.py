"""What the process and the card did beside each session of the window.

``begin()`` before a session and ``end()`` after it give the process's
own CPU seconds in the session (all its threads) and, on a card, the SM
clock, temperature, power draw and active clock-throttle reasons that
``nvidia-smi`` reads right after it.  A session whose wall rises while
its own CPU seconds stay put waited on something else; one whose CPU
seconds rise with it did more host work, or the same work on a slower
core.  Read outside the session's time.  (The machine's sandbox shows
no host load: its ``/proc/loadavg`` reads 0 and its ``/proc/stat`` is
absent.)"""

from __future__ import annotations

import resource
import subprocess

GPU_QUERY = ("clocks.sm", "temperature.gpu", "power.draw",
             "clocks_throttle_reasons.active")
COLUMNS = ("cpu_s", "sm_mhz", "temp_c", "power_w", "throttle")


def _cpu_s() -> float:
    r = resource.getrusage(resource.RUSAGE_SELF)
    return r.ru_utime + r.ru_stime


def _gpu() -> list:
    try:
        out = subprocess.run(
            ["nvidia-smi", "-i", "0",
             "--query-gpu=" + ",".join(GPU_QUERY),
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=10).stdout.strip().split(", ")
    except (OSError, subprocess.SubprocessError):
        return [None] * len(GPU_QUERY)
    if len(out) != len(GPU_QUERY):
        return [None] * len(GPU_QUERY)
    return [_num(v) for v in out[:-1]] + [out[-1]]


def _num(v: str):
    try:
        return float(v)
    except ValueError:               # "[N/A]" where the card does not say
        return None


def begin() -> float:
    return _cpu_s()


def end(start: float, card: bool) -> list:
    """One row of ``COLUMNS`` for the session begun at ``start``."""
    return [_cpu_s() - start] + (_gpu() if card else
                                 [None] * len(GPU_QUERY))
