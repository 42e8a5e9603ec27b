"""The traced sub-window put down to the port's spans
(``portbench.spans``): device time and idle time by span on synthetic
device operations, launch events and spans, the readings taken from
them, and whole traced runs on the CPU with spans on and against a port
without them."""
import time

import numpy as np
import pytest

from portbench import harness, spans
from repro_torch import obs

MS = 1_000_000  # ns
A = (1 << 40) + 5   # a thread whose pthread_self() passes 32 bits
B = 7


def drained(events):
    """``obs.Drained`` of ``(name, +1 enter / -1 leave, t_ns, tid)``."""
    names = sorted({e[0] for e in events})
    code = [(names.index(n) + 1) * sign for n, sign, _, _ in events]
    col = lambda k: np.asarray([e[k] for e in events], np.int64)  # noqa: E731
    return obs.Drained(names, np.asarray(code, np.int64), col(2), col(3),
                       np.zeros(len(events), np.int64), 0, {})


def scene():
    """Thread A: ``plan.run`` 0-10 ms holding ``plan.reseat`` 6-9 ms, then
    ``serve.wait`` 12-20 ms; thread B: a collection 14-16 ms.  K1 1-5 ms,
    a fill 6.5-7.5 and a copy 7.5-8.5, an op 20.5-22 launched outside
    every span, and one 22-23 ms whose launch event is missing; an op
    that ends a gap starts as it is launched (the copy waits behind the
    fill); window 0-25 ms."""
    sp = obs.pair(drained([
        ("plan.run", 1, 0, A), ("plan.reseat", 1, 6 * MS, A),
        ("plan.reseat", -1, 9 * MS, A), ("plan.run", -1, 10 * MS, A),
        ("serve.wait", 1, 12 * MS, A), ("host.gc", 1, 14 * MS, B),
        ("host.gc", -1, 16 * MS, B), ("serve.wait", -1, 20 * MS, A)]))
    k1 = "hfav_kernel(hfav::Params<4, 20, float>)"
    ops = [(1 * MS, 5 * MS, k1, 1), (int(6.5 * MS), int(7.5 * MS), "fill", 2),
           (int(7.5 * MS), int(8.5 * MS), "copy", 3),
           (int(20.5 * MS), 22 * MS, "late", 4), (22 * MS, 23 * MS, "lost", 9)]
    key = spans.thread_key(A)
    at = {1: 1 * MS, 2: int(6.5 * MS), 3: int(6.6 * MS), 4: int(20.5 * MS)}
    launches = {c: (t, t + MS // 20, key) for c, t in at.items()}
    return ops, launches, sp


def test_device_time_by_span_through_the_launch_events():
    ops, launches, sp = scene()
    att = spans.attribute(ops, launches, sp, 0, 25 * MS)
    assert att.device_by_span == pytest.approx({
        "plan.run": 0.004, "plan.reseat": 0.002, spans.CALLER: 0.0015,
        spans.NO_LAUNCH: 0.001})
    assert att.device_s == pytest.approx(0.0085)
    assert att.launched_s == pytest.approx(0.0075)
    assert att.spanned_s == pytest.approx(0.006)
    assert att.violations == 0 and att.window_s == pytest.approx(0.025)


def test_idle_by_span_takes_the_collector_first_then_the_launcher():
    ops, launches, sp = scene()
    att = spans.attribute(ops, launches, sp, 0, 25 * MS)
    # 0-1 before K1: plan.run; 5-6 plan.run, 6-6.5 plan.reseat; 8.5-9
    # plan.reseat, 9-10 plan.run, 10-12 nothing open, 12-14 and 16-20
    # serve.wait, 14-16 the collection (on B), 20-20.5 nothing open;
    # 23-25 the tail, nothing open on A
    assert att.idle_by_span == pytest.approx({
        "plan.run": 0.003, "plan.reseat": 0.001, spans.CALLER: 0.0045,
        "serve.wait": 0.006, spans.GC: 0.002})
    busy = 0.004 + 0.002 + 0.0015 + 0.001
    assert sum(att.idle_by_span.values()) == pytest.approx(0.025 - busy)
    label, secs = att.gaps[0]
    assert label == "serve.wait | copy -> late"
    assert secs == pytest.approx(0.012)
    assert [g[1] for g in att.gaps] == sorted((g[1] for g in att.gaps),
                                              reverse=True)
    assert att.gaps[1][0] == f"{spans.CALLER} | lost -> (window edge)"
    assert att.gaps[-1][0].startswith("plan.run | (window edge) -> hfav")


def test_a_gap_lies_on_the_host_clock_where_its_op_was_launched():
    """The fill launched at 6.5 ms on the host starts at 9.5 ms on the
    device (a clock 3 ms apart): the 4.5 ms gap before it is 2-6.5 ms on
    the host, 2-6 plan.run and 6-6.5 plan.reseat."""
    ops, launches, sp = scene()
    ops[1] = (int(9.5 * MS), int(10.5 * MS), "fill", 2)
    ops[2] = (int(10.5 * MS), int(11.5 * MS), "copy", 3)
    att = spans.attribute(ops, launches, sp, 0, 25 * MS)
    assert att.idle_by_span["plan.run"] == pytest.approx(0.001 + 0.004)
    assert att.idle_by_span["plan.reseat"] == pytest.approx(0.0005)
    assert att.device_drift_s == pytest.approx(0.0)  # K1's and late's: 0


def test_a_gap_names_the_runtime_call_that_covers_it():
    ops, launches, sp = scene()
    key = spans.thread_key(A)
    calls = [("cudaMalloc", 12 * MS, 15 * MS, key),
             ("cudaEventQuery", 5 * MS, 5 * MS + 1000, key),
             ("cudaFree", 13 * MS, 19 * MS, spans.thread_key(B))]
    att = spans.attribute(ops, launches, sp, 0, 25 * MS, calls)
    assert att.gaps[0][0] == \
        "serve.wait [cudaMalloc 0.003000 s] | copy -> late"
    assert "[" not in att.gaps[-1][0]  # 0.001 ms of a 1 ms gap


def test_a_launch_that_ends_after_its_span_is_a_clock_violation():
    ops, launches, sp = scene()
    launches[3] = (int(6.6 * MS), int(9.5 * MS), launches[3][2])
    att = spans.attribute(ops, launches, sp, 0, 25 * MS)
    assert att.violations == 1


def test_host_events_go_on_the_spans_clock_by_the_marks():
    """Each end's offset is its marks' least ``start - a`` (the first
    call after the profiler starts is slow); launches lie on the line
    through the two."""
    q = spans.MARK
    calls = [(q, 180, 190, 0, 1), (q, 205, 207, 0, 1),
             ("cudaLaunchKernel", 5000, 5010, 7, 1),
             (q, 10_050, 10_052, 0, 1), (q, 10_080, 10_082, 0, 1)]
    offsets = spans.host_offsets(calls, [(100, 195), (200, 209)],
                                 [(10_000, 10_055), (10_030, 10_085)])
    assert offsets == [(205, 5), (10_050, 50)]
    assert spans.to_span_clock(205, offsets) == 200
    assert spans.to_span_clock(10_050, offsets) == 10_000
    assert spans.launch_events(calls, offsets) == {
        7: (5000 - 27, 5010 - 27, 1)}
    assert spans.to_span_clock(5000, []) == 5000
    assert spans.host_offsets(calls[1:], [(100, 195), (200, 209)],
                              [(10_000, 10_055), (10_030, 10_085)]) == []


def test_host_time_by_span_is_each_spans_self_time_in_the_window():
    _, _, sp = scene()
    got = spans.host_by_span(sp, 1 * MS, 18 * MS)
    # plan.run 1-10 less plan.reseat 6-9; serve.wait 12-18; the
    # collection on B 14-16 is its own
    assert got == pytest.approx({"plan.run": 0.006, "plan.reseat": 0.003,
                                 "serve.wait": 0.006, "host.gc": 0.002})


def test_readings():
    ops, launches, sp = scene()
    att = spans.attribute(ops, launches, sp, 0, 25 * MS)
    setup = obs.pair(drained([
        ("engine.compile", 1, 0, A), ("engine.compile", 1, 1 * MS, A),
        ("engine.compile", -1, 3 * MS, A), ("engine.compile", -1, 4 * MS, A),
        ("engine.compile", 1, 5 * MS, A), ("engine.compile", -1, 6 * MS, A)]))
    r = spans.readings(att, {"k1.launch": 4}, 2, setup)
    assert r["compile_ms"] == pytest.approx(5.0)
    assert r["reseat_us"] == pytest.approx(1000.0)
    assert r["pad_us"] is None and r["unpad_us"] is None
    assert r["k1_launches"] == 2.0
    assert r["idle_wait_share"] == pytest.approx(0.006 / 0.025 * 100)
    # plan.run, plan.reseat and the collection
    assert r["idle_dispatch_share"] == pytest.approx(0.006 / 0.025 * 100)
    assert r["idle_caller_share"] == pytest.approx(0.0045 / 0.025 * 100)


def test_readings_with_nothing_to_read():
    r = spans.readings(None, {}, 0, None)
    assert set(r) == {"compile_ms", "reseat_us", "pad_us", "stack_us",
                      "unpad_us", "k1_launches", "idle_wait_share",
                      "idle_dispatch_share", "idle_caller_share"}
    assert all(v is None for v in r.values())


SMALL = {"cosmo-step": ({"Nk": 2, "Nj": 12, "Ni": 20}, None),
         "cosmo-ens": ({"Nk": 2, "Nj": 12, "Ni": 20},
                       {"clients": 3, "serve": {"max_batch": 3,
                                                "max_wait_ms": 2.0,
                                                "quantum": 32}})}


def traced(cell, with_spans=True):
    dims, mix = SMALL[cell]
    kw = dict(device="cpu", dims=dims, mix=mix)
    if with_spans:
        return spans.run(cell, 2**31 + 7, 0.6, **kw)
    return harness.run_cell(cell, 2**31 + 7, 0.6, True,
                            t_start=time.perf_counter(), **kw)


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_a_traced_run_with_spans_adds_to_the_line_only(cell):
    plain = traced(cell, with_spans=False)
    line = traced(cell)
    assert set(line["metrics"]) == set(plain["metrics"])
    assert list(line["metrics"]) == list(plain["metrics"])
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps", "counters"}
    got = line["spans"]
    assert got["overflow"] == 0
    assert got["readings"]["compile_ms"] > 0
    # the plain interpreter on the CPU: no device trace, no K1
    assert got["readings"]["reseat_us"] is None
    assert not obs._on


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_against_a_port_without_spans_the_line_is_the_harness_own(
        cell, monkeypatch):
    monkeypatch.setattr(spans, "obs", None)
    plain = traced(cell, with_spans=False)
    line = traced(cell)
    assert "spans" not in line
    assert set(line) == set(plain)
    assert set(line["breakdown"]) == set(plain["breakdown"])
    assert set(line["metrics"]) == set(plain["metrics"])
