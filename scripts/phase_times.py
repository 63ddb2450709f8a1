"""Time chosen phases of ``chip_smoke.py`` from one or more checkouts, on
one card, in one call.

    python3 scripts/phase_times.py --root DIR [--root DIR ...] \\
        --phases k1a,k1[,k1col,planetary,camera,multidevice,live] \\
        [--seed 0] [--repeat 2]

Each root (a checkout holding ``chip_smoke.py`` and ``siril_tpu_torch/``,
e.g. the parent commit unpacked by ``git archive`` into a gitignored
directory) runs in a process of its own, its package first on the path:
the card phase, then the phases asked for, each timed by ``chip_smoke``'s
``Phase`` lines.  With ``--repeat 2`` the roots run in the order A, B, B,
A (parent, change, change, parent), so that a drift of the host shows.
``camera`` runs the formats phase's camera-raw and save-command parts
(``formats_start``, ``formats_raw``) in a directory of their own;
``live`` runs the script phase first, in directories of its own, and
also reports its own seconds without it.
Each run prints one JSON line ``{"root": …, "phase": seconds, …}``; the
CUDA source builds at its first use in each root.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

CHILD = r"""
import json, multiprocessing, os, shutil, sys, tempfile, time
sys.path.insert(0, os.getcwd())
import chip_smoke as cs

def camera(seed):
    d = tempfile.mkdtemp(prefix="phase_times_camera_")
    pool = multiprocessing.get_context("spawn").Pool(4)
    try:
        rows, checks, timings = {}, {}, {}
        pending = cs.formats_start(seed, d, pool)
        cs.formats_raw(pending, d, rows, checks, timings)
        bad = [k for k, ok in checks.items() if not ok]
        if bad:
            raise RuntimeError(f"camera checks failed: {bad}")
    finally:
        pool.terminate()
        pool.join()
        shutil.rmtree(d, ignore_errors=True)

def live(seed):
    osc, root = tempfile.mkdtemp(), tempfile.mkdtemp()
    try:
        night = cs.phase_script(seed, osc, root)[3]
        t = time.perf_counter()
        with cs.Phase("live"):
            cs.phase_live(seed, root, night)
        return time.perf_counter() - t
    finally:
        shutil.rmtree(osc, ignore_errors=True)
        shutil.rmtree(root, ignore_errors=True)

PHASES = {"k1a": lambda s: cs.phase_k1a(s), "k1": lambda s: cs.phase_k1(s),
          "k1col": lambda s: cs.phase_k1col(s),
          "planetary": lambda s: cs.phase_planetary(s), "camera": camera,
          "multidevice": lambda s: cs.phase_multidevice(s), "live": live}

if __name__ == "__main__":
    seed = int(sys.argv[1])
    out = {"root": os.getcwd()}
    with cs.Phase("card"):
        cs.phase_card()
    for name in sys.argv[2].split(","):
        t = time.perf_counter()
        with cs.Phase(name):
            inner = PHASES[name](seed)
        out[name] = time.perf_counter() - t
        if name == "live":
            out["live (without the script phase)"] = inner
    print(json.dumps(out), flush=True)
"""


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", action="append", required=True)
    ap.add_argument("--phases", required=True)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--repeat", type=int, default=1)
    a = ap.parse_args(argv)
    roots = [os.path.abspath(r) for r in a.root]
    order = roots if a.repeat < 2 else roots + roots[::-1]
    rc = 0
    for root in order:
        proc = subprocess.run([sys.executable, "-c", CHILD, str(a.seed),
                               a.phases], cwd=root, text=True,
                              capture_output=True)
        sys.stdout.write(proc.stdout)
        sys.stderr.write(proc.stderr[-4000:])
        sys.stdout.flush()
        if proc.returncode:
            rc = proc.returncode
            print(json.dumps({"root": root, "failed": proc.returncode}),
                  flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
