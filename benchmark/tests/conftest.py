"""CPU tests of the benchmark harness (``python -m pytest
benchmark/tests`` from the root of the checkout).  Tests that need a
card carry the ``cuda`` marker and decide inside the test whether there
is one."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card (skips without one)")


#: each configuration cut to a size the CPU runs in seconds (the
#: planetary disc keeps its frame: only the frame count falls)
TINY = {"deepsky_mono_imx571": dict(width=320, height=256, lights=5,
                                    flats=5, stars_per_mpix=3000.0),
        "planetary_mono_640x480": dict(frames=16)}


def with_parked() -> dict:
    """BENCHMARK.json with the entries ``parked.json`` keeps out of it,
    so that the parked cells' generators and references stay tested."""
    from benchmark.harness.spec import HERE, ROOT, load_json

    bench = load_json(os.path.join(ROOT, "BENCHMARK.json"))
    parked = load_json(os.path.join(HERE, "parked.json"))
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        bench[key] = bench[key] + parked[key]
    return bench


def tiny_cell(name: str):
    from benchmark.harness.spec import load_cell

    cell = load_cell(name, with_parked())
    cell.config.update(TINY[cell.config["name"]])
    return cell


def run_tiny(name: str, seed: int = 2147483711, tmp=None, trace=False):
    """One run of the cell at the tiny size on the CPU, the look for a
    card skipped: its result dict."""
    import time

    import torch

    from benchmark.harness.runner import run_cell

    torch.set_num_threads(2)
    return run_cell(tiny_cell(name), seed, 0.5, trace, time.perf_counter(),
                    device="cpu", workroot=str(tmp) if tmp else None)
