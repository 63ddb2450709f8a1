"""The benchmark's description, and the files it names.

``BENCHMARK.json`` at the root of the checkout lists configurations,
cells and metrics.  Everything that belongs to one of them is found by
its name: ``configs/<config>.json``, ``traffic/<mix>.json``,
``metrics/<metric>.py`` and the reader of a command's outputs that the
mix names, ``outputs/<module>.py``, under this folder.  A new cell, configuration or
metric is new files and new entries, and no edit."""

from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)


@dataclass
class Metric:
    name: str
    unit: str
    better: str
    source: str
    workloads: Optional[List[str]]
    read: Callable                 # read(run) -> float or None


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: List[Metric]
    per_layer: List[Metric]
    #: outputs(session object, workdir, traffic) -> what the check reads
    outputs: Callable


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _load(folder: str, sub: str, stem: str):
    path = os.path.join(folder, sub, stem + ".py")
    spec = importlib.util.spec_from_file_location(
        f"benchmark.{sub}." + stem.replace(".", "__"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_metric_reader(name: str, folder: str = HERE) -> Callable:
    """``read`` of ``metrics/<name>.py`` (the file name may hold dots)."""
    return _load(folder, "metrics", name).read


def load_outputs_reader(name: str, folder: str = HERE) -> Callable:
    """The function ``<fn>`` of ``outputs/<module>.py`` for ``name`` =
    ``"<module>.<fn>"``."""
    module, fn = name.rsplit(".", 1)
    return getattr(_load(folder, "outputs", module), fn)


def _metrics(entries, cell: str, folder: str) -> List[Metric]:
    out = []
    for m in entries:
        wl = m.get("workloads")
        if wl is not None and cell not in wl:
            continue
        out.append(Metric(m["name"], m["unit"], m["better"], m["source"],
                          wl, load_metric_reader(m["name"], folder)))
    return out


def load_cell(name: str, bench: Optional[dict] = None,
              folder: str = HERE) -> Cell:
    """The cell ``name`` of ``bench`` (default: the checkout's
    BENCHMARK.json) with its configuration, traffic and metric readers."""
    bench = bench if bench is not None else \
        load_json(os.path.join(ROOT, "BENCHMARK.json"))
    wl = {w["name"]: w for w in bench["workloads"]}
    if name not in wl:
        raise KeyError(f"no workload named {name!r} in BENCHMARK.json")
    w = wl[name]
    cfgs: Dict[str, dict] = {c["name"]: c for c in bench["configs"]}
    cfg = load_json(os.path.join(ROOT, cfgs[w["config"]]["file"]))
    traffic = load_json(os.path.join(folder, "traffic",
                                     w["traffic"] + ".json"))
    return Cell(name, int(w["chips"]), cfg, traffic,
                _metrics(bench["end_to_end"], name, folder),
                _metrics(bench["per_layer"], name, folder),
                load_outputs_reader(traffic["outputs"], folder))
