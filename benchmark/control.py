"""The readings the check's limits are set from, for one cell.

    python3 benchmark/control.py --workload <cell> --seeds 1,2,3 \\
        [--control-seeds 1,2,3] [--out FILE]

For each of ``--seeds`` it makes the cell's inputs, runs one session of
the program (after one warm-up session on the first seed) and prints
the check's numbers: the lower readings, or with ``--fault`` the
readings of a program with that fault planted.  For each of
``--control-seeds`` it prints the numbers of the control, the reference
computed in bfloat16 put in the program's place: the upper readings.
One JSON line per reading, also appended to ``--out``.  The benchmark's
own runs never run this."""

from __future__ import annotations

import argparse
import gc
import importlib
import json
import os
import shutil
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def readings(workload: str, seeds, control_seeds, device: str = "cuda",
             out=None, cell=None, workroot=None, tag=None):
    import torch

    from benchmark import gen
    from benchmark.harness.runner import run_session
    from benchmark.harness.spec import load_cell

    cell = cell or load_cell(workload)
    cfg, traffic = cell.config, cell.traffic
    check = importlib.import_module(
        f"benchmark.reference.check_{traffic['check']}")
    dev = torch.device(device)
    rows = []
    warm = False
    for kind, seed in [("program", s) for s in seeds] + \
            [("control", s) for s in control_seeds]:
        workdir = tempfile.mkdtemp(prefix="siril_ctl_",
                                   dir=workroot or tempfile.gettempdir())
        try:
            t = time.perf_counter()
            truth = gen.make(traffic["generator"], cfg, traffic, seed,
                             workdir, dev)
            if kind == "program":
                script = os.path.join(workdir, "session.ssf")
                with open(script, "w") as f:
                    f.write(traffic["command"] + "\n")
                frames = int(cfg[traffic["frames_key"]])
                px = frames * cfg["height"] * cfg["width"]
                if not warm:
                    run_session(workdir, script, device, frames, px)
                    warm = True
                ctx, rec = run_session(workdir, script, device, frames, px)
                outs = cell.outputs(ctx, workdir, traffic)
                del ctx
                gc.collect()
                if device.startswith("cuda"):
                    torch.cuda.empty_cache()
                nums = check.judge(cfg, traffic, truth, workdir, outs, dev)
            else:
                nums = check.control(cfg, traffic, truth, workdir, dev)
            row = {"workload": workload,
                   "kind": f"{kind} with {tag}" if tag else kind,
                   "seed": seed,
                   "numbers": nums, "seconds": time.perf_counter() - t}
        finally:
            shutil.rmtree(workdir, ignore_errors=True)
            if device.startswith("cuda"):
                torch.cuda.empty_cache()
        rows.append(row)
        print(json.dumps(row), flush=True)
        if out:
            with open(out, "a") as f:
                f.write(json.dumps(row) + "\n")
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--out", default=None)
    ap.add_argument("--fault", default=None,
                    help="plant a fault of benchmark/tests/"
                    "test_cell_control.py under the program's seeds "
                    "(its name without the leading underscore)")
    a = ap.parse_args(argv)
    if a.fault:
        import pytest

        from benchmark.tests import test_cell_control as faults

        getattr(faults, "_" + a.fault)(pytest.MonkeyPatch())

    def ints(s):
        return [int(v) for v in s.split(",") if v]

    readings(a.workload, ints(a.seeds), ints(a.control_seeds), out=a.out,
             tag=a.fault)
    return 0


if __name__ == "__main__":
    sys.exit(main())
