"""One run of one cell: set-up, the measured window, the check, and with
``trace`` one profiled session.

Set-up makes the cell's inputs from the seed on the device, writes them
under a fresh directory of ``TMPDIR``, and runs one session to warm the
cell's shapes (the K1 library comes from the build directory inside the
checkout, built by the first run there).  The window then runs sessions
back to back, closed loop, each the cell's command through the
program's own entry (``siril_tpu_torch.cli.run`` with ``-s``, as a user's
script runs it), and keeps every session started within the window's
seconds whole.  Between sessions, outside their time, the harness writes
back the last result, drops the last session's objects and returns the
device memory they held to the card, so that each session starts as a
user's process would: with nothing of another session left.  The check
runs once the window has closed and the peak memory has been read."""

from __future__ import annotations

import gc
import importlib
import os
import shutil
import sys
import tempfile
import time
from typing import Dict, List, Optional, Tuple

from benchmark.harness import host
from benchmark.harness.record import Run, Session
from benchmark.harness.spec import Cell

#: top-level module names that may not be loaded in a run's process
FORBIDDEN = ("jax", "jaxlib", "flax", "siril_tpu")


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name (before the first dot) is one
    of ``FORBIDDEN``, compared whole."""
    return sorted({m for m in list(sys.modules)
                   if m.split(".", 1)[0] in FORBIDDEN})


def power_limit() -> str:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    import subprocess

    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"unread: {type(e).__name__}"


def _cuda(device: str) -> bool:
    return device.startswith("cuda")


def run_session(workdir: str, script: str, device: str, frames: int,
                pixels: int) -> Tuple[object, Session]:
    """The cell's script through the program's entry; the session object
    and its record."""
    import torch

    from siril_tpu_torch import cli

    t = time.perf_counter()
    ctx = cli.run(["-d", workdir, "--device", device, "-s", script])
    if _cuda(device):
        torch.cuda.synchronize()
    wall = time.perf_counter() - t
    entry = ctx.command_log[-1]
    peak = torch.cuda.max_memory_allocated() if _cuda(device) else 0
    return ctx, Session(wall, dict(entry["stages"]), frames, pixels, peak,
                        dict(entry["launches"]))


def settle(workdir: str) -> None:
    """Write back what the last session wrote in ``workdir`` (its result)
    before the next one starts, so that no session runs beside the
    write-back of another's output; outside the sessions' time."""
    for e in os.scandir(workdir):
        if e.is_file():
            fd = os.open(e.path, os.O_RDONLY)
            try:
                os.fsync(fd)
            finally:
                os.close(fd)


def window(session_fn, seconds: float, between=lambda: None):
    """Sessions back to back while the window is open; every session
    started within ``seconds`` runs whole.  Returns (sessions, the last
    session's object, sessions that raised)."""
    done, last, failed = [], None, 0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        last = None                      # the previous session's objects
        between()
        try:
            last, rec = session_fn()
            done.append(rec)
        except Exception as e:          # the run goes on: it is reported
            failed += 1
            print(f"session failed: {type(e).__name__}: {e}",
                  file=sys.stderr, flush=True)
    return done, last, failed


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             t_start: float, device: str = "cuda",
             workroot: Optional[str] = None) -> dict:
    """The run's result as a dict (see ``run.py`` for the printed line)."""
    import torch

    from benchmark import gen
    from benchmark.harness import trace as trace_mod

    cfg, traffic = cell.config, cell.traffic
    cuda = _cuda(device)
    dev = torch.device(device)
    workdir = tempfile.mkdtemp(prefix="siril_bench_",
                               dir=workroot or tempfile.gettempdir())
    try:
        truth = gen.make(traffic["generator"], cfg, traffic, seed, workdir,
                         dev)
        script = os.path.join(workdir, "session.ssf")
        with open(script, "w") as f:
            f.write(traffic["command"] + "\n")
        frames = int(cfg[traffic["frames_key"]])
        pixels = frames * int(cfg["height"]) * int(cfg["width"])

        def one():
            return run_session(workdir, script, device, frames, pixels)

        def probed():
            h = host.begin()
            ctx, rec = one()
            rec.host = host.end(h, cuda)
            return ctx, rec

        def between():
            settle(workdir)
            gc.collect()
            if cuda:
                torch.cuda.empty_cache()

        one()                            # warm-up: the cell's own shapes
        if cuda:
            torch.cuda.synchronize()
        setup_s = time.perf_counter() - t_start

        sessions, last, failed = window(probed, seconds, between)
        peak = max((s.peak_bytes for s in sessions), default=0)

        outs = cell.outputs(last, workdir, traffic) \
            if last is not None else None
        del last
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
        check = importlib.import_module(
            f"benchmark.reference.check_{traffic['check']}")
        numbers = check.judge(cfg, traffic, truth, workdir, outs, dev) \
            if outs is not None else {}
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()

        run = Run(cell.name, cfg, traffic, setup_s, sessions)
        if trace:
            between()
            (_, run.traced), run.trace = trace_mod.profile_session(one)
        leaked = forbidden_modules()
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    limits = traffic["limits"]
    checks = {k: {"value": v, "limit": limits[k]} for k, v in numbers.items()}
    correct = bool(numbers) and failed == 0 and \
        all(c["value"] <= c["limit"] for c in checks.values())
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        if m.source == "device_trace" and not cuda:
            continue                 # device numbers come from a card only
        v = m.read(run)
        if v is not None:
            metrics[m.name] = {"value": v, "unit": m.unit}
    device_info: Dict[str, object] = {
        "platform": "gpu" if cuda else "cpu",
        "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
        "count": cell.chips, "memory_peak_bytes": int(peak)}
    out = {"correct": correct, "attempted": len(sessions) + failed,
           "failed": failed, "metrics": metrics, "device": device_info,
           "leaked": leaked, "power_limit": power_limit() if cuda else None,
           "sessions": [[s.wall_s, s.stages] for s in sessions],
           "host": {"columns": list(host.COLUMNS),
                    "rows": [s.host for s in sessions]}}
    if trace:
        t = run.trace
        device_info["busy_s"] = t.busy_s
        device_info["window_s"] = t.window_s
        # the profiler's own host cost stretches the profiled session; the
        # idle metrics take its busy time over the window's mean session
        out["trace_walls"] = {
            "profiled_span_s": t.window_s,
            "profiled_session_s": run.traced.wall_s,
            "window_session_mean_s": run.mean_wall(),
            "idle_pct_over_profiled_span":
                100.0 * (1.0 - t.busy_s / t.window_s)}
        top = sorted(t.op_seconds.items(), key=lambda kv: -kv[1])[:10]
        out["breakdown"] = {"device_ops": [[n, s] for n, s in top],
                            "idle_gaps": [[n, s] for n, s in t.idle_gaps]}
    out["checks"] = checks
    return out
