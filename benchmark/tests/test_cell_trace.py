"""The device's busy and idle share and the K1 byte count, from synthetic
profiler events."""

import pytest

from benchmark.harness import trace as tr
from benchmark.harness.record import Run, Session
from benchmark.harness.spec import load_metric_reader
from benchmark.metrics import _spans


class Ev:
    """A stand-in for a profiler event (times in ms)."""

    def __init__(self, name, kind, t0, t1):
        self._n, self._k = name, kind
        self._t0, self._t1 = int(t0 * 1e6), int(t1 * 1e6)

    def name(self):
        return self._n

    def device_type(self):
        on_cpu = self._k in ("user_annotation", "cpu_op")
        return "DeviceType.CPU" if on_cpu else "DeviceType.CUDA"

    def is_user_annotation(self):
        return self._k.endswith("user_annotation")

    def start_ns(self):
        return self._t0

    def duration_ns(self):
        return self._t1 - self._t0


EVENTS = [
    Ev("before", "kernel", 0, 5),                 # outside the session
    Ev(tr.SESSION_SPAN, "user_annotation", 10, 110),
    Ev("fused.detect", "user_annotation", 10, 60),
    Ev("fused.stack", "user_annotation", 60, 110),
    Ev("aten::sort", "cpu_op", 12, 14),
    Ev("sortKernel", "kernel", 12, 20),
    Ev("sortKernel", "kernel", 15, 25),           # overlaps the first
    Ev("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy", 40, 45),
    Ev("register_kernel<float, 24, false, 1>", "kernel", 70, 80),
    Ev("register_kernel<float, 24, false, 1>", "kernel", 80, 90),
    Ev("after", "kernel", 120, 130),
]


def test_union_and_gaps():
    assert _spans.busy_seconds([(0, 2), (1, 3), (5, 6)], 0, 10) == 4
    assert _spans.busy_seconds([(0, 2)], 1, 10) == 1
    assert _spans.gaps([(2, 3), (5, 9)], 0, 10) == [(0, 2), (3, 5),
                                                    (9, 10)]


def test_busy_and_idle_over_the_session_span():
    t = tr.read_events(EVENTS)
    assert t.window_s == pytest.approx(0.100)
    # 12-25, 40-45, 70-90: 38 ms of 100
    assert t.busy_s == pytest.approx(0.038)
    # the idle share is taken over the window's mean session (76 ms), not
    # over the profiled session's span
    window = [Session(0.060, {}, 24, 24 * 1000),
              Session(0.092, {}, 24, 24 * 1000)]
    run = Run("c", {}, {}, 0.0, window, trace=t,
              traced=Session(1.0, {}, 24, 24 * 1000))
    for cell in ("deepsky", "planetary"):
        assert load_metric_reader(f"device_idle_pct.{cell}")(run) == \
            pytest.approx(50.0)
        assert load_metric_reader(f"device_idle_pct.{cell}")(
            Run("c", {}, {}, 0.0, [], trace=t)) is None
    assert load_metric_reader("launches_per_frame.planetary")(run) == \
        pytest.approx(4 / 24)
    names = [n for n, _ in t.idle_gaps]
    assert names[0].startswith("fused.detect")      # 45-60 and 25-40
    assert any(n.startswith("fused.stack") for n in names)


def test_k1_byte_count_and_roofline():
    k1 = tr.read_events(EVENTS)
    read = load_metric_reader("k1_bytes_roofline_pct.deepsky")
    import importlib.util
    import os

    from benchmark.harness.spec import HERE
    sp = importlib.util.spec_from_file_location(
        "k1m", os.path.join(HERE, "metrics",
                            "k1_bytes_roofline_pct.deepsky.py"))
    mod = importlib.util.module_from_spec(sp)
    sp.loader.exec_module(mod)
    P = 6248 * 4176
    assert mod.stack_bytes(24, P) == 24 * P * 4 + P * 4
    run = Run("c", {}, {}, 0.0, [], trace=k1,
              traced=Session(1.0, {}, 24, 24 * P))
    # 20 ms of K1 against the bound of (24·P·4 + P·4) bytes at 3.35 TB/s
    want = 100 * (25 * P * 4 / 3.35e12) / 0.020
    assert read(run) == pytest.approx(want)


def test_no_k1_no_reading():
    t = tr.read_events([e for e in EVENTS
                        if "register_kernel" not in e.name()])
    run = Run("c", {}, {}, 0.0, [], trace=t,
              traced=Session(1.0, {}, 24, 24))
    assert load_metric_reader("k1_bytes_roofline_pct.deepsky")(run) is None


def test_a_trace_without_the_session_span_is_an_error():
    with pytest.raises(RuntimeError):
        tr.read_events([e for e in EVENTS if e.name() != tr.SESSION_SPAN])
