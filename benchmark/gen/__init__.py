"""Input generators.  A traffic file names its generator as
``"<module>.<function>"`` of this package (``deepsky.lights``); the
function takes (configuration, traffic, seed, directory, device), writes
the cell's input files into the directory and returns the truth it
drew."""

from __future__ import annotations

import importlib


def make(name: str, cfg: dict, traffic: dict, seed: int, root: str, dev):
    module, fn = name.rsplit(".", 1)
    mod = importlib.import_module(f"benchmark.gen.{module}")
    return getattr(mod, fn)(cfg, traffic, seed, root, dev)
