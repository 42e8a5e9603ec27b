"""The trace's reduction and the per-layer readers, on synthetic
intervals and counters."""
import types

import pytest

from portbench import metrics, spread
from portbench.generator import Window
from portbench.trace import K1_NAME, summarize

MS = 1_000_000  # ns


def events():
    # K1 0-4 ms, a fill 4-5 ms, a copy 5-6 ms, idle 6-8 ms, K1 8-12 ms,
    # a copy overlapping it 11-13 ms
    k1 = f"{K1_NAME}(hfav::Params<4, 20, float>)"
    return [(0, 4 * MS, k1), (4 * MS, 5 * MS, "void fill_kernel"),
            (5 * MS, 6 * MS, "Memcpy DtoD (Device -> Device)"),
            (8 * MS, 12 * MS, k1), (11 * MS, 13 * MS, "copy_kernel")]


def test_summarize_union_names_and_gaps():
    s = summarize(events(), window_s=0.016)
    assert s.busy_s == pytest.approx(0.011)
    assert s.k1_s == pytest.approx(0.008)
    assert s.other_s == pytest.approx(0.004)
    assert s.by_name["fill_kernel"] == pytest.approx(0.001)
    assert len(s.gaps) == 1
    label, secs = s.gaps[0]
    assert secs == pytest.approx(0.002)
    assert label == "Memcpy DtoD (Device -> Device) -> " + \
        f"{K1_NAME}(hfav::Params<4, 20, float>)"


def test_summarize_nothing():
    s = summarize([], window_s=1.0)
    assert s.busy_s == 0 and s.gaps == [] and s.by_name == {}


def fake_run(trace=None, window=None):
    return types.SimpleNamespace(
        points=10**6, least_s=8e6 / 3.35e12, setup_s=7.5, plan_ms=3.0,
        trace=trace,
        window=window or Window(attempted=10, failed=0, examples=10,
                                window_s=2.0))


def test_readers_of_the_trace():
    t = summarize(events(), window_s=0.016)
    t.examples = 2
    run = fake_run(trace=t)
    least = 8e6 / 3.35e12
    assert metrics.load("copy_us").read(run) == pytest.approx(2000.0)
    assert metrics.load("k1_roofline").read(run) == \
        pytest.approx(2 * least / 0.008 * 100)
    assert metrics.load("step_mfu").read(run) == \
        pytest.approx(2 * least / 0.016 * 100)
    assert metrics.load("idle_share").read(run) == \
        pytest.approx((1 - 0.011 / 0.016) * 100)


@pytest.mark.parametrize("name", ["copy_us", "k1_roofline", "step_mfu",
                                  "idle_share", "queue_ms", "batch_mean",
                                  "p95_ms"])
def test_readers_with_nothing_to_read_return_none(name):
    assert metrics.load(name).read(fake_run()) is None


def test_readers_of_the_window():
    w = Window(attempted=4, failed=1, examples=3, window_s=0.5,
               latencies_ms=[float(x) for x in range(1, 21)],
               stats=[{"queue_wait_ms": q, "batch_size": b}
                      for q, b in ((1.0, 2), (3.0, 2), (2.0, 4))])
    run = fake_run(window=w)
    assert metrics.load("points_per_s").read(run) == \
        pytest.approx(3 * 10**6 / 0.5 / 1e9)
    assert metrics.load("p95_ms").read(run) == 19.0
    assert metrics.load("queue_ms").read(run) == 2.0
    assert metrics.load("batch_mean").read(run) == pytest.approx(8 / 3)
    assert metrics.load("setup_s").read(run) == 7.5
    assert metrics.load("plan_ms").read(run) == 3.0


def test_roofline_is_left_out_on_an_unknown_card():
    t = summarize(events(), window_s=0.016)
    t.examples = 2
    run = fake_run(trace=t)
    run.least_s = None
    assert metrics.load("k1_roofline").read(run) is None
    assert metrics.load("step_mfu").read(run) is None


def test_spread_is_the_quartile_distance_over_the_median():
    s = spread.spread([10.0, 11.0, 12.0, 13.0, 14.0, 15.0])
    assert s["median"] == 12.5
    assert (s["q1"], s["q3"]) == (10.75, 14.25)
    assert s["spread"] == pytest.approx(3.5 / 12.5)


def test_schedule_traces_the_middle_half_of_the_window():
    import time
    from portbench.generator import Schedule

    class Tracer:
        started = stopped = 0

        def start(self):
            self.t0 = time.perf_counter()
            self.started += 1

        def stop(self):
            self.stopped += 1

    tracer = Tracer()
    sched = Schedule(0.4, tracer)
    n = traced = 0
    while sched.more(n > 0):
        traced += sched.tracing
        n += 1
        time.sleep(0.002)
    sched.close()
    assert tracer.started == tracer.stopped == 1
    assert 0.2 < traced / n < 0.8
    assert time.perf_counter() - sched.t0 >= 0.4


def test_schedule_untraced_runs_at_least_once():
    from portbench.generator import Schedule
    sched = Schedule(0.0)
    assert sched.more(False) and not sched.more(True)
    assert not sched.tracing
