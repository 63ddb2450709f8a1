"""The window's arithmetic: whole sessions started within the window,
and a rate over all their work and all their time."""

import pytest

from benchmark.harness import runner
from benchmark.harness.record import Run, Session
from benchmark.harness.spec import load_metric_reader


class Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


@pytest.mark.parametrize("durations,seconds,expect", [
    ([3.0] * 10, 10.0, 4),          # starts at 0, 3, 6, 9: four, whole
    ([4.0, 1.0, 6.0, 2.0], 5.0, 2),  # starts at 0 and 4; 5 is out
    ([20.0], 5.0, 1),
])
def test_whole_sessions_started_within(monkeypatch, durations, seconds,
                                       expect):
    clock = Clock()
    monkeypatch.setattr(runner.time, "perf_counter", clock)
    it = iter(durations)

    def one():
        d = next(it)
        clock.t += d
        return None, Session(d, {}, 2, 200)

    done, _, failed = runner.window(one, seconds)
    assert len(done) == expect and failed == 0
    assert [s.wall_s for s in done] == durations[:expect]


def test_failed_sessions_are_counted(monkeypatch):
    clock = Clock()
    monkeypatch.setattr(runner.time, "perf_counter", clock)

    def one():
        clock.t += 2.0
        raise RuntimeError("broken")

    done, last, failed = runner.window(one, 5.0)
    assert done == [] and last is None and failed == 3


def test_rates_over_all_work_and_time():
    s = [Session(2.0, {"read": 0.5, "detect": 1.0}, 24, 24_000_000),
         Session(3.0, {"read": 0.7, "detect": 1.2}, 24, 24_000_000)]
    run = Run("c", {}, {}, 10.0, s)
    assert load_metric_reader("deepsky_mpix_per_s")(run) == \
        pytest.approx(48.0 / 5.0)
    assert load_metric_reader("planetary_frames_per_s")(run) == \
        pytest.approx(48 / 5.0)
    assert load_metric_reader("read_ms_per_frame.deepsky")(run) == \
        pytest.approx(1e3 * 1.2 / 48)
    assert load_metric_reader("detect_ms_per_frame")(run) == \
        pytest.approx(1e3 * 2.2 / 48)
    assert load_metric_reader("warp_ms_per_frame")(run) is None
    assert load_metric_reader("cli_rest_s.deepsky")(run) == \
        pytest.approx(((2.0 - 1.5) + (3.0 - 1.9)) / 2)
    assert load_metric_reader("setup_s")(run) == 10.0


def test_peak_is_the_largest_session():
    s = [Session(1.0, {}, 1, 1, peak_bytes=2 ** 30),
         Session(1.0, {}, 1, 1, peak_bytes=3 * 2 ** 30)]
    for name in ("peak_device_gib", "peak_device_gib.planetary"):
        assert load_metric_reader(name)(Run("c", {}, {}, 0.0, s)) == 3.0
