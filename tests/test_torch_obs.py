"""The port's spans and counters (``repro_torch.obs``): off, a shared
no-op that records and allocates nothing; on, nested spans with parents
and idents per thread in a bounded buffer, collections as ``host.gc``
spans, and times on the profiler's clock; the spans of a plan's run and
of one PlanServe batch; counters, and PlanServe's bounded metrics."""
import gc
import sys
import threading

import numpy as np
import pytest
import torch

from repro_torch import obs
from repro_torch.core import ALL_PROGRAMS, clear_compile_cache, compile_program
from repro_torch.kernels.stencil2d import kernel as k1
from repro_torch.serve.plans import SAMPLE_WINDOW, PlanServe, ServeMetrics


@pytest.fixture(autouse=True)
def spans_off():
    """Every test starts and ends with spans off and an empty buffer."""
    obs.disable()
    obs.drain()
    yield
    obs.disable()
    obs.enable()  # back to the default capacity
    obs.disable()
    obs.drain()


@pytest.fixture
def no_gc():
    """No collection (and so no ``host.gc`` span) while the test runs."""
    gc.disable()
    yield
    gc.enable()


def spans_of(drained):
    s = obs.pair(drained)
    return [(s.label(i), int(s.parent[i]), int(s.tid[i]), int(s.ident[i]),
             int(s.start[i]), int(s.end[i])) for i in range(len(s))]


def test_off_is_one_shared_noop_that_records_and_allocates_nothing():
    assert obs.span("a") is obs.span("b", 7)
    gc.collect()
    before = sys.getallocatedblocks()
    for i in range(20000):
        with obs.span("plan.run", i):
            pass
    assert sys.getallocatedblocks() - before < 50
    d = obs.drain()
    assert len(d.code) == 0 and d.overflow == 0


def test_on_nests_spans_with_parents_and_idents_per_thread(no_gc):
    obs.enable()
    both = threading.Barrier(2, timeout=30)
    tids = {}

    def worker():
        tids["worker"] = threading.get_ident()
        with obs.span("outer", 3):
            both.wait()
            with obs.span("inner", 4):
                both.wait()

    t = threading.Thread(target=worker)
    t.start()
    tids["main"] = threading.get_ident()
    with obs.span("outer", 1):
        both.wait()
        with obs.span("inner", 2):
            both.wait()
    t.join(30)
    assert not t.is_alive()
    spans = spans_of(obs.drain())
    assert len(spans) == 4
    by = {(name, ident): (i, parent, tid, start, end)
          for i, (name, parent, tid, ident, start, end) in enumerate(spans)}
    for outer, inner, who in ((1, 2, "main"), (3, 4, "worker")):
        oi, oparent, otid, ostart, oend = by[("outer", outer)]
        _, iparent, itid, istart, iend = by[("inner", inner)]
        assert oparent == -1 and iparent == oi
        assert otid == itid == tids[who]
        assert ostart <= istart <= iend <= oend


def test_buffer_is_bounded_and_counts_what_it_drops(no_gc):
    obs.enable(capacity=10)
    for i in range(8):  # 16 events, 10 kept
        with obs.span("s", i):
            pass
    d = obs.drain()
    assert len(d.code) == 10 and d.overflow == 6
    spans = spans_of(d)
    assert [s[3] for s in spans] == [0, 1, 2, 3, 4]
    assert all(s[5] >= s[4] for s in spans)
    assert obs.drain().overflow == 0


def test_an_exit_whose_entry_was_dropped_is_skipped(no_gc):
    obs.enable(capacity=3)
    with obs.span("a"):
        with obs.span("b"):
            pass  # b's exit is the buffer's third event
    with obs.span("c"):  # dropped whole
        pass
    d = obs.drain()
    assert d.overflow == 3
    spans = spans_of(d)
    assert [(s[0], s[1]) for s in spans] == [("a", -1), ("b", 0)]
    assert spans[0][5] == obs.OPEN  # a's exit was dropped


def test_collections_are_host_gc_spans_while_on():
    obs.enable()
    with obs.span("work"):
        gc.collect()
    spans = spans_of(obs.drain())
    gcs = [s for s in spans if s[0] == "host.gc"]
    assert gcs and gcs[-1][3] == 2 and spans[gcs[-1][1]][0] == "work"
    obs.disable()
    gc.collect()
    assert len(obs.drain().code) == 0


def test_span_times_are_on_the_profilers_clock():
    from torch.profiler import ProfilerActivity, profile
    x = torch.ones(1 << 16)
    obs.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with obs.span("clock"):
            y = torch.add(x, 1.0)
    (start, end), = [(s[4], s[5]) for s in spans_of(obs.drain())
                     if s[0] == "clock"]
    assert float(y[0]) == 2.0
    adds = [e for e in prof.profiler.kineto_results.events()
            if e.name() == "aten::add"]
    assert adds
    for e in adds:
        assert start <= e.start_ns() <= e.start_ns() + e.duration_ns() <= end


def test_counters_count_always_and_k1_launches_reads_its_counter():
    base = obs.counter("test.count")
    obs.count("test.count", 2)
    obs.count("test.count")
    assert obs.counter("test.count") == base + 3
    assert obs.drain().counters["test.count"] == base + 3
    launches = k1.launches
    assert launches == obs.counter("k1.launch")
    obs.count("k1.launch")
    assert k1.launches == launches + 1
    with pytest.raises(AttributeError):
        k1.no_such_name


def test_counters_lose_no_update_across_threads():
    base = obs.counter("test.threads")
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(
            target=lambda: [obs.count("test.threads") for _ in range(2000)])
            for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert obs.counter("test.threads") == base + 16 * 2000


def children(spans, i):
    return [s[0] for s in spans if s[1] == i]


def test_a_plans_run_and_its_compile_are_spans(no_gc):
    clear_compile_cache()
    prog = ALL_PROGRAMS["normalization"]()
    u = np.random.default_rng(3).standard_normal((9, 14)).astype(np.float32)
    obs.enable()
    gen = compile_program(prog, "interp_torch", device="cpu")
    gen.fn(u=u)
    spans = spans_of(obs.drain())
    roots = [(i, s[0]) for i, s in enumerate(spans) if s[1] == -1]
    assert [name for _, name in roots] == ["engine.compile", "plan.run"]
    run = roots[1][0]
    kids = children(spans, run)
    assert kids[0] == "plan.inputs"
    assert {"plan.host", "plan.reseat"} <= set(kids)
    assert set(kids) <= {"plan.inputs", "plan.host", "plan.reseat"}


def test_one_planserve_batch_is_one_span_tree_joined_by_ids(no_gc):
    clear_compile_cache()
    prog = ALL_PROGRAMS["laplace5"]()
    rng = np.random.default_rng(5)
    cells = [rng.standard_normal((9, 17)).astype(np.float32)
             for _ in range(3)]
    with PlanServe({"laplace5": prog}, device="cpu", max_batch=3,
                   max_wait_ms=60_000.0) as srv:
        srv.prefill("laplace5", {"Nj": 9, "Ni": 17}, batch=3)
        obs.enable()
        tickets = [srv.submit("laplace5", {"cell": c}) for c in cells]
        for t in tickets:
            t.result(120)
        obs.disable()
    spans = spans_of(obs.drain())
    main = threading.get_ident()
    submits = [s for s in spans if s[0] == "serve.submit"]
    assert [s[3] for s in submits] == [t.stats["request_id"]
                                      for t in tickets]
    assert all(s[2] == main and s[1] == -1 for s in submits)
    bid = tickets[0].stats["batch_id"]
    assert all(t.stats["batch_id"] == bid for t in tickets)
    (collect,) = [s for s in spans if s[0] == "serve.collect"]
    (batch,) = [i for i, s in enumerate(spans) if s[0] == "serve.batch"]
    assert collect[3] == spans[batch][3] == bid and collect[2] != main
    assert collect[5] <= spans[batch][4]
    kids = [s for s in spans if s[1] == batch]
    # members of one size: run from their own tensors, nothing padded,
    # stacked or unpadded
    assert [s[0] for s in kids] == ["plan.run", "plan.run", "plan.run",
                                    "serve.finish", "serve.resolve"]
    assert all(s[3] == bid for s in kids if s[0].startswith("serve."))


def test_serve_metrics_keep_a_bounded_window_and_lifetime_counts():
    m = ServeMetrics()
    n = SAMPLE_WINDOW + 100
    for i in range(n):
        m.record_request(float(i), float(i) / 2)
    for size in (3, 5, 4):
        m.record_batch(("b",), size)
    assert len(m.latency_ms) == len(m.queue_wait_ms) == SAMPLE_WINDOW
    snap = m.snapshot()
    assert snap["requests"] == n and snap["batches"] == 3
    assert snap["latency_ms"]["max"] == float(n - 1)
    assert snap["latency_ms"]["mean"] == pytest.approx(
        np.mean(np.arange(100, n)))
    assert snap["batch_size"] == {"mean": 4.0, "max": 5}
    assert snap["buckets"]["('b',)"] == {"batches": 3, "requests": 12}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    return torch.device("cuda:0")


@pytest.mark.cuda
def test_k1_launch_and_build_spans_on_card(cuda_device, no_gc):
    """On the card a plan's run holds ``k1.launch``, and the first call
    at a size builds or loads the library and fixes the launch inside
    it (``kernel.build``)."""
    clear_compile_cache()
    gen = compile_program(ALL_PROGRAMS["cosmo"](), "cuda",
                          device=cuda_device, use_cache=False)
    u = torch.randn(4, 40, 72, device=cuda_device)
    before = k1.launches
    obs.enable()
    gen.fn(u=u)
    gen.fn(u=u)
    torch.cuda.synchronize()
    spans = spans_of(obs.drain())
    assert k1.launches - before == 2
    launches = [i for i, s in enumerate(spans) if s[0] == "k1.launch"]
    assert len(launches) == 2
    assert all(spans[spans[i][1]][0] == "plan.run" for i in launches)
    assert children(spans, launches[0]) == ["kernel.build"]
    assert children(spans, launches[1]) == []
