"""The readers of the program's span record: on hand-built runs whose
sessions the program's held log entries describe, on a cell with no
detection and no dark, and on a program that keeps no record; the
readers that were there read the same with the record held as without;
and a tiny traced run on the CPU reads each of them."""

import pytest

from benchmark.harness import trace as tr
from benchmark.harness.record import Run, Session
from benchmark.harness.spec import HERE, ROOT, load_json, load_metric_reader
from benchmark.tests.test_cell_trace import EVENTS, Ev

NEW = ["detect_fit_ms_per_frame", "detect_finish_ms_per_frame",
       "detect_device_busy_pct", "detect_kept_pct",
       "masters_deviant_s.deepsky", "cli_load_s.deepsky", "write_s.deepsky",
       "frame_reads_per_frame.deepsky", "detect_refits_per_frame"]
MS = 1_000_000                                   # ns a millisecond


@pytest.fixture
def held(monkeypatch):
    """The program's held log entries, emptied for the test."""
    from collections import deque

    from siril_tpu_torch.utils import trace

    monkeypatch.setattr(trace, "_recent", deque(maxlen=trace.RECENT))
    return trace


def _entry(stages, spans, counters, events=()):
    return dict(command="fusedstack", stages=dict(stages), spans=spans,
                counters=counters, events=list(events))


def _lights(held):
    """Two window sessions of 24 frames and a profiled one, as lights24
    has them."""
    s1 = Session(9.0, {"masters": 1.001, "detect": 4.801}, 24, 24 * 1000)
    s2 = Session(11.0, {"masters": 1.002, "detect": 5.202}, 24, 24 * 1000)
    traced = Session(13.0, {"masters": 1.003, "detect": 6.003}, 24,
                     24 * 1000)
    for s, fit, fin, dev, load, write, cand, stars in (
            (s1, 2.4, 1.2, 0.6, 0.40, 0.10, 1000, 600),
            (s2, 2.6, 1.4, 0.8, 0.50, 0.20, 1000, 500)):
        held.keep(_entry(s.stages, {
            "cli.command": [1, s.wall_s, 0.1],
            "fused.detect.fit": [24, fit + 0.5, fit],
            "fused.detect.finish": [1, fin, fin],
            "fused.masters.deviant": [1, dev, dev],
            "cli.load": [1, load, load], "cli.write": [1, write, write]},
            {"io.frames_read": 26, "detect.candidates": cand,
             "detect.stars": stars, "detect.refits": 10}))
    # the profiled session's record on the profiler's clock: its root
    # closes as the harness's session span (10-110 ms in EVENTS) does
    held.keep(_entry(traced.stages, {"cli.command": [1, 0.099, 0.05]},
                     {"io.frames_read": 26}, [
                         ("cli.command", -1, 11 * MS, 110 * MS),
                         ("fused.detect", 0, 12 * MS, 30 * MS),
                         ("fused.detect.fit", 1, 13 * MS, 14 * MS),
                         ("fused.detect", 0, 38 * MS, 50 * MS)]))
    return Run("c", {}, {}, 1.0, [s1, s2], trace=tr.read_events(EVENTS),
               traced=traced)


def test_readers_on_a_lights_run(held):
    run = _lights(held)
    got = {m: load_metric_reader(m)(run) for m in NEW}
    assert got["detect_fit_ms_per_frame"] == pytest.approx(1e3 * 5.0 / 48)
    assert got["detect_finish_ms_per_frame"] == pytest.approx(1e3 * 2.6 / 48)
    assert got["detect_kept_pct"] == pytest.approx(100 * 1100 / 2000)
    assert got["masters_deviant_s.deepsky"] == pytest.approx(0.7)
    assert got["cli_load_s.deepsky"] == pytest.approx(0.45)
    assert got["write_s.deepsky"] == pytest.approx(0.15)
    assert got["frame_reads_per_frame.deepsky"] == pytest.approx(52 / 48)
    assert got["detect_refits_per_frame"] == pytest.approx(20 / 48)
    # within 12-30 ms the sorts run 12-25, within 38-50 the copy 40-45
    assert got["detect_device_busy_pct"] == pytest.approx(100 * 18 / 30)


def test_no_detection_and_no_dark_reads_nothing_there(held):
    s = [Session(2.0, {"read": 0.801, "stack": 0.011}, 32, 32 * 1000),
         Session(2.2, {"read": 0.902, "stack": 0.012}, 32, 32 * 1000)]
    for x in s:
        held.keep(_entry(x.stages, {"cli.command": [1, 2.0, 0.1],
                                    "cli.load": [1, 0.3, 0.3],
                                    "cli.write": [1, 0.1, 0.1]},
                         {"io.frames_read": 34}))
    traced = Session(2.5, {"read": 1.003, "stack": 0.013}, 32, 32 * 1000)
    held.keep(_entry(traced.stages, {"cli.command": [1, 2.4, 0.1]}, {},
                     [("cli.command", -1, 11 * MS, 110 * MS)]))
    run = Run("c", {}, {}, 1.0, s, trace=tr.read_events(EVENTS),
              traced=traced)
    got = {m: load_metric_reader(m)(run) for m in NEW}
    for m in ("detect_fit_ms_per_frame", "detect_finish_ms_per_frame",
              "detect_device_busy_pct", "detect_kept_pct",
              "masters_deviant_s.deepsky", "detect_refits_per_frame"):
        assert got[m] is None, m
    assert got["cli_load_s.deepsky"] == pytest.approx(0.3)
    assert got["write_s.deepsky"] == pytest.approx(0.1)
    assert got["frame_reads_per_frame.deepsky"] == pytest.approx(68 / 64)


def test_a_program_without_the_record_reads_nothing(held, monkeypatch):
    run = _lights(held)
    monkeypatch.delattr(held, "recent")         # as a program before it
    assert all(load_metric_reader(m)(run) is None for m in NEW)


def test_a_session_is_its_own_entry(held):
    run = _lights(held)
    other = Run("c", {}, {}, 1.0, [Session(9.0, {"masters": 1.0}, 24, 24)])
    assert load_metric_reader("cli_load_s.deepsky")(other) is None
    assert load_metric_reader("cli_load_s.deepsky")(
        Run("c", {}, {}, 1.0, run.sessions[1:])) == pytest.approx(0.5)


def test_a_window_longer_than_the_held_entries_reads_nothing(held):
    """Sessions whose entries the program no longer holds leave every
    reader of the record with nothing, not with the sessions still
    held."""
    n = held.RECENT + 8
    sessions = [Session(2.0, {"read": 0.5 + i * 1e-6}, 32, 32) for i in
                range(n)]
    for s in sessions:
        held.keep(_entry(s.stages, {"cli.load": [1, 0.3, 0.3],
                                    "cli.write": [1, 0.1, 0.1]},
                         {"io.frames_read": 34}))
    assert len(held.recent()) == held.RECENT
    whole = Run("c", {}, {}, 1.0, sessions)
    assert all(load_metric_reader(m)(whole) is None for m in NEW)
    tail = Run("c", {}, {}, 1.0, sessions[-held.RECENT:])
    assert load_metric_reader("cli_load_s.deepsky")(tail) == \
        pytest.approx(0.3)


def test_a_session_that_refits_nothing_reads_zero(held):
    s = Session(9.0, {"detect": 4.5}, 24, 24)
    held.keep(_entry(s.stages, {}, {"detect.candidates": 100,
                                    "detect.stars": 90}))
    assert load_metric_reader("detect_refits_per_frame")(
        Run("c", {}, {}, 1.0, [s])) == 0.0


def _every_reader():
    names = set()
    for f in (f"{ROOT}/BENCHMARK.json", f"{HERE}/parked.json"):
        b = load_json(f)
        names |= {m["name"] for m in b["end_to_end"] + b["per_layer"]}
    return sorted(names - set(NEW))


@pytest.mark.parametrize("name", _every_reader())
def test_readers_that_were_there_read_the_same(held, name):
    run = _lights(held)
    with_record = load_metric_reader(name)(run)
    held._recent.clear()
    assert load_metric_reader(name)(run) == with_record


@pytest.mark.parametrize("cell,reads", [
    ("deepsky_mono_imx571.lights24", 7 / 5),
    ("deepsky_mono_imx571.flats32_noreg", 7 / 5)])
def test_a_tiny_traced_run_reads_them(cell, reads, tmp_path):
    from benchmark.tests.conftest import run_tiny

    res = run_tiny(cell, tmp=tmp_path, trace=True)
    assert res["correct"], res["checks"]
    m = res["metrics"]
    assert m["frame_reads_per_frame.deepsky"]["value"] == \
        pytest.approx(reads)
    assert m["cli_load_s.deepsky"]["value"] > 0
    assert m["write_s.deepsky"]["value"] > 0
    assert m["cli_load_s.deepsky"]["value"] + m["write_s.deepsky"]["value"] \
        <= m["cli_rest_s.deepsky"]["value"]
    lights = cell.endswith("lights24")
    for name in ("detect_fit_ms_per_frame", "detect_finish_ms_per_frame",
                 "detect_kept_pct", "masters_deviant_s.deepsky",
                 "detect_refits_per_frame"):
        assert (name in m) == lights, name
    if lights:
        assert 0 < m["detect_kept_pct"]["value"] <= 100
        assert m["detect_fit_ms_per_frame"]["value"] + \
            m["detect_finish_ms_per_frame"]["value"] <= \
            m["detect_ms_per_frame"]["value"]
    # device numbers come from a card only
    assert "detect_device_busy_pct" not in m
