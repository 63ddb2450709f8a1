"""The command's span record (``siril_tpu_torch/utils/trace.py``): nesting,
parents and self time, counters, the 4096-event cap, the profiler's
clock, and the record of a ``fusedstack`` and an ``mpp`` run through the
CLI on the CPU — their stages unchanged, their sub-spans adding no
device synchronize."""

import threading

import numpy as np
import pytest
import torch

from siril_tpu_torch import cli
from siril_tpu_torch.core.image import FLOAT_IMG, SirilImage
from siril_tpu_torch.io.fits_io import write_fits
from siril_tpu_torch.utils import trace

#: the stages a calibrated, registered fusedstack has always kept
FUSED_STAGES = {"masters", "read", "upload", "calibrate", "detect", "match",
                "normalize", "warp", "stack", "fetch"}
MPP_STAGES = {"quality", "global", "reference", "shifts", "sidecar",
              "stack", "assembly"}


class FakeClock:
    def __init__(self, monkeypatch):
        self.t = 0
        monkeypatch.setattr(trace, "_now", lambda: self.t)


def test_record_nesting_parents_and_self_time(monkeypatch):
    clk = FakeClock(monkeypatch)
    with trace.command() as rec:                  # 0 .. 110
        clk.t = 10
        with trace.stage("a"):                    # 10 .. 60
            clk.t = 20
            with trace.stage("b"):                # 20 .. 30
                clk.t = 30
            clk.t = 40
            with trace.stage("b"):                # 40 .. 55
                clk.t = 55
            clk.t = 60
        clk.t = 70
        with trace.stage("c"):                    # 70 .. 100
            th = threading.Thread(target=lambda: trace.stage("other")
                                  .__enter__().__exit__(None, None, None))
            th.start()
            th.join()
            clk.t = 100
        clk.t = 110
    out = rec.result()
    ns = 1e-9
    want = {"cli.command": [1, 110, 110 - 50 - 30], "a": [1, 50, 50 - 25],
            "b": [2, 25, 25], "c": [1, 30, 30]}
    assert set(out["spans"]) == set(want)          # no span of the thread
    for name, (n, tot, own) in want.items():
        assert out["spans"][name][0] == n
        assert out["spans"][name][1] == pytest.approx(tot * ns)
        assert out["spans"][name][2] == pytest.approx(own * ns)
    A = trace._ANCHOR_NS
    assert out["events"] == [("cli.command", -1, A, 110 + A),
                             ("a", 0, 10 + A, 60 + A),
                             ("b", 1, 20 + A, 30 + A),
                             ("b", 1, 40 + A, 55 + A),
                             ("c", 0, 70 + A, 100 + A)]
    assert out["counters"] == {}


def test_counters_in_and_out_of_a_command():
    trace.count("unit.outside", 3)              # no command: goes nowhere
    with trace.command() as outer:
        trace.count("unit.a")
        trace.count("unit.a", 4)
        th = threading.Thread(target=trace.count, args=("unit.thread", 2))
        th.start()
        th.join()
        with trace.command() as inner:
            trace.count("unit.inner")
        trace.count("unit.b", 0)
    trace.count("unit.after")
    assert outer.result()["counters"] == {"unit.a": 5, "unit.thread": 2,
                                          "unit.b": 0}
    assert inner.result()["counters"] == {"unit.inner": 1}
    assert set(inner.result()["spans"]) == {"cli.command"}


def test_event_cap_and_dropped_counter():
    n = trace.EVENTS_CAP + 4
    with trace.command() as rec:
        for _ in range(n):
            with trace.stage("unit.x"):
                pass
    out = rec.result()
    assert len(out["events"]) == trace.EVENTS_CAP == 4096
    assert out["counters"]["trace.events_dropped"] == n + 1 - 4096
    assert out["spans"]["unit.x"][0] == n         # totals count them all


def test_spans_share_the_profiler_clock():
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.command() as rec:
            for i in range(3):
                with trace.stage(f"unit.s{i}"):
                    torch.ones(256, 256).sum()
                    with trace.stage("unit.inner"):
                        torch.ones(64).cumsum(0)
    ev = {}
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith("unit.") or e.name() == "cli.command":
            ev.setdefault(e.name(), []).append(e.start_ns())
    seen = {}
    events = rec.result()["events"]
    assert len(events) == 7
    for name, _, t0, t1 in events:
        k = seen.get(name, 0)
        seen[name] = k + 1
        starts = sorted(ev[name])
        assert abs(t0 - starts[k]) < 1_000_000, name     # 1 ms
        assert t1 > t0


def test_stage_seconds_and_record_outside_a_command():
    with trace.stage("unit.lone") as sp:
        pass
    assert sp.seconds >= 0.0
    assert trace.timings()["unit.lone"][0] >= 1


def test_held_entries_keep_events_only_in_the_newest(monkeypatch):
    from collections import deque

    monkeypatch.setattr(trace, "_recent", deque(maxlen=trace.RECENT))
    logged = [dict(stages={"s": float(i)}, spans={}, counters={},
                   events=[("cli.command", -1, i, i + 1)])
              for i in range(trace.RECENT + 3)]
    for e in logged:
        trace.keep(e)
    held = trace.recent()
    assert len(held) == trace.RECENT
    assert held[-1] is logged[-1]
    assert [e["stages"]["s"] for e in held] == \
        [float(i) for i in range(3, trace.RECENT + 3)]
    assert all("events" not in e and "spans" in e for e in held[:-1])
    assert all("events" in e for e in logged)    # the log keeps its own


# ---------------------------------------------------------------------------
# fusedstack and mpp through the CLI
# ---------------------------------------------------------------------------


def _field(rng, h=160, w=192):
    yy, xx = np.mgrid[0:h, 0:w]
    base = 0.05 + rng.normal(0, 0.002, (h, w))
    for _ in range(16):
        x0, y0 = rng.uniform(30, w - 30), rng.uniform(30, h - 30)
        base += 0.5 * np.exp(-((xx + 0.5 - x0) ** 2 + (yy + 0.5 - y0) ** 2)
                             / 8.0)
    return np.clip(base, 0, 1)


@pytest.fixture(scope="module")
def fused(tmp_path_factory):
    """A calibrated, registered fusedstack of 5 lights through a script,
    every device synchronize counted."""
    from siril_tpu_torch import device
    from siril_tpu_torch.ops import stacking

    d = tmp_path_factory.mktemp("fused")
    rng = np.random.default_rng(3)
    base = _field(rng)
    h, w = base.shape
    for i, (dx, dy) in enumerate([(0, 0), (4, 2), (-3, 5), (6, -4), (2, 2)]):
        f = np.roll(np.roll(base, dy, 0), dx, 1) + \
            rng.normal(0, 0.002, base.shape)
        f[rng.integers(0, h, 30), rng.integers(0, w, 30)] = 0.95
        write_fits(SirilImage(data=np.clip(f, 1e-4, 1)[None].astype(
            np.float32)), str(d / f"fl_{i:05d}.fit"), bitdepth=16)
    dark = 0.002 + rng.normal(0, 0.0002, (1, h, w))
    dark[0, rng.integers(0, h, 20), rng.integers(0, w, 20)] = 0.3
    for name, m in (("bias", 0.001 + 0 * dark), ("dark", dark),
                    ("flat", 0.5 + 0.05 * rng.random((1, h, w)))):
        write_fits(SirilImage(data=np.asarray(m, np.float32)),
                   str(d / f"{name}.fit"), bitdepth=FLOAT_IMG)
    (d / "s.ssf").write_text("fusedstack fl_ rej 3 3 -norm=addscale "
                             "-bias=bias -dark=dark -flat=flat -cc=dark "
                             "-out=result\n")
    calls = []
    real = device.synchronize
    mp = pytest.MonkeyPatch()

    def counted(dev):
        calls.append(dev)
        real(dev)

    mp.setattr(device, "synchronize", counted)
    mp.setattr(stacking, "synchronize", counted)
    try:
        ctx = cli.run(["-d", str(d), "--device", "cpu", "-s",
                       str(d / "s.ssf")])
    finally:
        mp.undo()
    return ctx, calls, d


def test_fusedstack_record_keeps_the_stages(fused):
    ctx, _, d = fused
    assert (d / "result.fit").exists()
    e = ctx.command_log[-1]
    assert set(e["stages"]) == FUSED_STAGES
    spans = e["spans"]
    for k, sec in e["stages"].items():
        assert spans["fused." + k][1] == pytest.approx(sec, rel=1e-9), k
    assert {"cli.command", "cli.load", "cli.write", "fused.masters.sample",
            "fused.masters.upload", "fused.masters.deviant",
            "fused.detect.stats", "fused.detect.candidates",
            "fused.detect.fit", "fused.detect.finish"} <= set(spans)
    assert spans["fused.detect.fit"][0] == 5
    assert spans["fused.detect.stats"][0] == 1      # one chunk
    names = [ev[0] for ev in e["events"]]
    parent = {ev[0]: names[ev[1]] if ev[1] >= 0 else None
              for ev in e["events"]}
    assert parent["cli.command"] is None
    assert parent["cli.load"] == parent["cli.write"] == "cli.command"
    assert parent["fused.masters"] == "cli.command"
    assert parent["fused.masters.deviant"] == "fused.masters"
    assert parent["fused.detect.fit"] == "fused.detect"
    assert parent["fused.detect.finish"] == "fused.detect"
    c = e["counters"]
    assert c["io.frames_read"] == 5 + 2      # + the first light twice
    assert c["detect.candidates"] >= c["detect.stars"] >= 5 * 8
    assert c.get("detect.refits", 0) >= 0
    assert trace.recent()[-1] is e


def test_fusedstack_sub_spans_add_no_synchronize(fused):
    ctx, calls, _ = fused
    e = ctx.command_log[-1]
    # one at the end of each StageClock stage, one at the command's end
    want = sum(e["spans"]["fused." + k][0] for k in e["stages"]) + 1
    assert len(calls) == want


def test_mpp_stages_are_spans(tmp_path):
    from scipy.ndimage import shift as ndshift

    from siril_tpu_torch.io.ser import SER_MONO, SerWriter

    rng = np.random.default_rng(5)
    H = W = 128
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    r = np.sqrt((yy - H / 2) ** 2 + (xx - W / 2) ** 2)
    disk = np.clip(1.0 - (r / (0.38 * H)) ** 8, 0.0, 1.0)
    scene = np.clip(0.05 + disk * (0.55 + 0.12 * np.sin(yy / H * 9 * np.pi)
                                   + 0.05 * np.cos(xx / 7.0)), 0, 1)
    wr = SerWriter(str(tmp_path / "planet.ser"), W, H, SER_MONO, 16)
    for _ in range(6):
        f = ndshift(scene, rng.uniform(-3, 3, 2), order=1, mode="nearest")
        f = f + rng.normal(0, 0.01, f.shape)
        wr.write_frame(SirilImage(data=np.clip(f, 0, 1)[None].astype(
            np.float32)))
    wr.close()
    (tmp_path / "m.ssf").write_text("mpp planet -out=m\n")
    ctx = cli.run(["-d", str(tmp_path), "--device", "cpu", "-s",
                   str(tmp_path / "m.ssf")])
    e = ctx.command_log[-1]
    assert set(e["stages"]) == MPP_STAGES
    for k, sec in e["stages"].items():
        assert e["spans"]["mpp." + k][1] == pytest.approx(sec, rel=1e-9), k
    names = [ev[0] for ev in e["events"]]
    for x in e["events"]:
        if x[0].startswith("mpp."):
            assert names[x[1]] == "cli.command", x[0]
