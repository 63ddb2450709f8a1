"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout, on a machine with as many CUDA devices as
the cell asks for.  The last line of standard output is one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer ones),
``device`` and, traced, ``breakdown``; its last key, ``checks``, holds
each number the check compared beside its limit, and the last lines of
standard error repeat them.  Without enough CUDA devices, or with the
JAX package or JAX loaded in this process, it prints no result and exits
with a code other than 0.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# caches of compiled code live at fixed paths inside the checkout
os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, ".bench_cache", "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(ROOT, ".bench_cache",
                                                  "torch_extensions")
# no library may load JAX on its own in this process
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)

    from benchmark.harness.spec import load_cell

    cell = load_cell(a.workload)
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"{a.workload} needs {cell.chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2

    # the program under test: a checkout without it fails here, at once
    import siril_tpu_torch.cli  # noqa: F401

    from benchmark.harness.runner import run_cell

    res = run_cell(cell, a.seed, a.seconds, bool(a.trace), T_START)
    return report(res)


def report(res: dict) -> int:
    """Print the result (or, with a forbidden module loaded, only that)."""
    leaked = res.pop("leaked")
    if leaked:
        print("forbidden modules loaded: " + ", ".join(leaked),
              file=sys.stderr, flush=True)
        return 3
    print(f"correct = {res['correct']}", file=sys.stderr)
    for name, c in res["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
