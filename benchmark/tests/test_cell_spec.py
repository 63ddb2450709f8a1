"""The description and the files it names: every cell resolves by name,
BENCHMARK.json keeps to the contract's shapes, and a new cell, traffic
mix and metric are new files and entries only."""

import copy
import json
import os
import re

import pytest

from benchmark.harness import spec
from benchmark.harness.record import Run, Session

BENCH = spec.load_json(os.path.join(spec.ROOT, "BENCHMARK.json"))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"][:2] == ["python3", "benchmark/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(spec.ROOT, "BENCHMARK.json")) \
        < 64 * 1024
    for p in BENCH["paths"]:
        assert os.path.isdir(os.path.join(spec.ROOT, p))


def test_names_units_and_keys():
    names = set()
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and all(NAME.match(k)
                                             for k in c["reduced"])
        assert os.path.isfile(os.path.join(spec.ROOT, c["file"]))
        cfg = spec.load_json(os.path.join(spec.ROOT, c["file"]))
        assert cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"]
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert m["name"] not in names
        names.add(m["name"])
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves_and_reports(cell):
    c = spec.load_cell(cell)
    e2e = {m.name for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert c.per_layer
    for m in c.per_layer:        # each moves an end-to-end metric it has
        moves = next(x["moves"] for x in BENCH["per_layer"]
                     if x["name"] == m.name)
        assert moves in e2e
    assert os.path.isfile(os.path.join(
        spec.HERE, "traffic", next(w["traffic"] for w in BENCH["workloads"]
                                   if w["name"] == cell) + ".json"))
    assert c.traffic["limits"] and c.config[c.traffic["frames_key"]] > 0


def test_new_cell_is_files_and_entries(tmp_path):
    """A throwaway cell with a new traffic mix, a new reader of its
    command's outputs and a new per-layer metric, found by name with no
    edit to any file that is there."""
    folder = tmp_path / "bench"
    (folder / "traffic").mkdir(parents=True)
    (folder / "metrics").mkdir()
    (folder / "outputs").mkdir()
    (folder / "outputs" / "throwaway_cmd.py").write_text(
        "def read(ctx, workdir, traffic):\n"
        "    return {'image': workdir + '/' + traffic['output']}\n")
    base = spec.load_cell(CELLS[0]).traffic
    mix = dict(base, why="a throwaway mix", outputs="throwaway_cmd.read")
    (folder / "traffic" / "throwaway_mix.json").write_text(json.dumps(mix))
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        src = os.path.join(spec.HERE, "metrics", m["name"] + ".py")
        (folder / "metrics" / (m["name"] + ".py")).write_text(
            open(src).read())
    (folder / "metrics" / "throwaway_metric.x.py").write_text(
        "def read(run):\n    return 2.0 * len(run.sessions)\n")
    bench = copy.deepcopy(BENCH)
    w0 = bench["workloads"][0]
    bench["workloads"].append(dict(w0, name="throwaway.cell",
                                   traffic="throwaway_mix"))
    bench["per_layer"].append({
        "name": "throwaway_metric.x", "unit": "1", "better": "lower",
        "source": "program_counter", "layer": "CLI and session",
        "moves": "setup_s", "workloads": ["throwaway.cell"]})
    c = spec.load_cell("throwaway.cell", bench, folder=str(folder))
    assert c.traffic["why"] == "a throwaway mix"
    assert c.outputs(None, "w", c.traffic) == \
        {"image": "w/" + c.traffic["output"]}
    m = next(m for m in c.per_layer if m.name == "throwaway_metric.x")
    run = Run("throwaway.cell", c.config, c.traffic, 1.0,
              [Session(1.0, {}, 1, 1)])
    assert m.read(run) == 2.0


def test_unknown_cell_is_an_error():
    with pytest.raises(KeyError):
        spec.load_cell("no.such_cell")
