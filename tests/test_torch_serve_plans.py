"""PlanServe in the port (``repro_torch.serve.plans``/``.workers``):
shape bucketing, pad/unpad exactness, the micro-batcher, the
compiled-bucket table and the batched-execution contract — batched
answers bit-identical to per-example ``compile_program`` on every
backend of ``VMAP_SAFE`` that runs on the CPU — and the port's server
held against the reference's PlanServe (``backend="jax"``) at
tolerance.  The ``"cuda"`` backend is held bit for bit on the card by
``chip_smoke.py``."""
import time

import numpy as np
import pytest
import torch

from repro_torch.core import (ALL_PROGRAMS, clear_compile_cache,
                              compile_batched, compile_program,
                              registered_interpreters)
from repro_torch.serve.plans import (DEFAULT_QUANTUM, VMAP_SAFE, PlanServe,
                                     bucket_sizes, is_reduction,
                                     pad_to_bucket, quantize, request_sizes,
                                     unpad_outputs)

CPU_BACKENDS = ["interp_torch", "torch"]


@pytest.fixture(autouse=True)
def _fresh_cache():
    clear_compile_cache()
    yield
    clear_compile_cache()


def _rng():
    return np.random.default_rng(7)


def _prog(name):
    return ALL_PROGRAMS[name]()


def _ref(name, arrays, backend="interp_torch"):
    return compile_program(_prog(name), backend, device="cpu").fn(**arrays)


def _serve(programs, **kw):
    return PlanServe({n: _prog(n) for n in programs}, device="cpu", **kw)


# ---------------------------------------------------------------------------
# Buckets and padding
# ---------------------------------------------------------------------------

def test_quantize():
    assert quantize(1, 32) == 32
    assert quantize(32, 32) == 32
    assert quantize(33, 32) == 64
    assert quantize(9, 1) == 9
    with pytest.raises(ValueError):
        quantize(0, 32)
    with pytest.raises(ValueError):
        quantize(5, 0)


def test_request_sizes_and_validation():
    prog = _prog("laplace5")
    u = np.zeros((9, 17), np.float32)
    assert request_sizes(prog, {"cell": u}) == {"Nj": 9, "Ni": 17}
    assert request_sizes(prog, {"cell": torch.zeros(9, 17)}) == \
        {"Nj": 9, "Ni": 17}
    with pytest.raises(ValueError, match="expects input arrays"):
        request_sizes(prog, {})
    with pytest.raises(ValueError, match="rank"):
        request_sizes(prog, {"cell": np.zeros((9,), np.float32)})
    with pytest.raises(ValueError, match="inconsistent size"):
        request_sizes(_prog("hydro1d"),
                      {"rho": np.zeros((5, 9)), "mom": np.zeros((5, 8))})


def test_bucket_key_is_canonical():
    prog = _prog("laplace5")
    assert bucket_sizes(prog, {"Nj": 9, "Ni": 17}, 8) == \
        (("Ni", 24), ("Nj", 16))


def test_reduction_detection():
    assert not is_reduction(_prog("laplace5"))
    assert is_reduction(_prog("energy3d"))
    assert is_reduction(_prog("row_sum"))
    assert is_reduction(_prog("normalization"))


@pytest.mark.parametrize("backend", CPU_BACKENDS)
@pytest.mark.parametrize("name,shape", [("laplace5", (9, 17)),
                                        ("heat3d", (5, 9, 17)),
                                        ("cosmo", (3, 9, 13))])
def test_pad_unpad_roundtrip_is_bit_identical(backend, name, shape):
    """The serving exactness contract: pad to a bucket, run the padded
    shape, re-seat — bit-identical to the unpadded run (goal stores
    seat only the valid region; the padded lanes never feed it)."""
    prog = _prog(name)
    arr = prog.axioms[0].term.ref.name
    u = _rng().standard_normal(shape).astype(np.float32)
    sizes = request_sizes(prog, {arr: u})
    bucket = bucket_sizes(prog, sizes, 8)
    padded = pad_to_bucket(prog, {arr: u}, bucket)
    assert all(p.device == torch.device("cpu") for p in padded.values())
    gen = compile_program(prog, backend, device="cpu")
    out = unpad_outputs(prog, gen.fn(**padded), sizes)
    want = gen.fn(**{arr: u})
    for k in want:
        assert torch.equal(out[k], want[k]), k


# ---------------------------------------------------------------------------
# compile_batched: the batch contract, every CPU backend
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", sorted(VMAP_SAFE - {"cuda"}))
def test_compile_batched_matches_per_example(backend):
    prog = _prog("laplace5")
    rng = _rng()
    batch = np.stack([rng.standard_normal((9, 17)).astype(np.float32)
                      for _ in range(3)])
    outs = compile_batched(prog, backend, device="cpu").fn({"cell": batch})
    gen = compile_program(prog, backend, device="cpu")
    for i in range(3):
        assert torch.equal(outs["lap"][i], gen.fn(cell=batch[i])["lap"])


def test_vmap_safe_backends_are_available():
    assert VMAP_SAFE <= {"torch"} | set(registered_interpreters())


# ---------------------------------------------------------------------------
# The serving engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", CPU_BACKENDS)
def test_serve_single_request_bit_identical(backend):
    u = _rng().standard_normal((9, 17)).astype(np.float32)
    with _serve(["laplace5"], backend=backend, max_wait_ms=1.0) as srv:
        assert srv.backend == backend
        out = srv.serve("laplace5", {"cell": u})
    assert torch.equal(out["lap"],
                       _ref("laplace5", {"cell": u}, backend)["lap"])


def test_default_backend_is_the_devices_stencil_interpreter(monkeypatch):
    with _serve(["laplace5"]) as srv:
        assert srv.backend == "interp_torch"
        assert srv.device == torch.device("cpu")
    # no card and no device asked for: it raises, never serving on the CPU
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PlanServe({"laplace5": _prog("laplace5")})


@pytest.mark.parametrize("backend", CPU_BACKENDS)
def test_batch_assembly_and_scatter_order(backend):
    """max_batch same-bucket requests coalesce into one batch, and each
    ticket gets *its own* request's outputs back."""
    rng = _rng()
    inputs = [rng.standard_normal((9, 17)).astype(np.float32)
              for _ in range(4)]
    with _serve(["laplace5"], backend=backend, max_batch=4,
                max_wait_ms=200.0) as srv:
        srv.prefill("laplace5", {"Nj": 9, "Ni": 17}, batch=4)
        tickets = [srv.submit("laplace5", {"cell": u}) for u in inputs]
        outs = [t.result(60) for t in tickets]
    for u, out, t in zip(inputs, outs, tickets):
        assert torch.equal(out["lap"],
                           _ref("laplace5", {"cell": u}, backend)["lap"])
        assert t.stats["batch_size"] == 4
    snap = srv.metrics.snapshot()
    assert snap["requests"] == 4
    assert snap["batches"] == 1
    assert snap["batch_size"]["max"] == 4


def test_max_wait_flushes_partial_batch():
    u = _rng().standard_normal((9, 17)).astype(np.float32)
    with _serve(["laplace5"], max_batch=16, max_wait_ms=30.0) as srv:
        t = srv.submit("laplace5", {"cell": u})
        out = t.result(60)
    assert torch.equal(out["lap"], _ref("laplace5", {"cell": u})["lap"])
    assert t.stats["batch_size"] == 1
    assert t.stats["queue_wait_ms"] >= 20.0


def test_mixed_sizes_land_in_distinct_buckets():
    rng = _rng()
    a = rng.standard_normal((9, 17)).astype(np.float32)    # -> (32, 32)
    b = rng.standard_normal((40, 40)).astype(np.float32)   # -> (64, 64)
    with _serve(["laplace5"], max_wait_ms=1.0) as srv:
        out_a = srv.serve("laplace5", {"cell": a})
        out_b = srv.serve("laplace5", {"cell": b})
        snap = srv.metrics.snapshot()
    assert torch.equal(out_a["lap"], _ref("laplace5", {"cell": a})["lap"])
    assert torch.equal(out_b["lap"], _ref("laplace5", {"cell": b})["lap"])
    # one compile serves every bucket of a program: nothing is traced
    # per shape, and the executor fixes one launch per bucket
    assert snap["compiles"]["count"] == 1
    assert len(snap["buckets"]) == 2


def test_bucket_compiles_once_across_requests():
    rng = _rng()
    with _serve(["laplace5"], max_wait_ms=1.0) as srv:
        for _ in range(5):
            n = int(rng.integers(5, 30))
            srv.serve("laplace5",
                      {"cell": rng.standard_normal((n, n)).astype(np.float32)})
        snap = srv.metrics.snapshot()
    assert snap["requests"] == 5
    assert snap["compiles"]["count"] == 1


@pytest.mark.parametrize("backend", CPU_BACKENDS)
def test_reduction_is_served_exactly(backend):
    """Reductions bucket exactly (quantum 1): zero-padding would change
    the reduce-tree shape, so PlanServe must not pad them."""
    u = _rng().standard_normal((4, 7, 20)).astype(np.float32)
    with _serve(["energy3d"], backend=backend, max_wait_ms=1.0) as srv:
        out = srv.serve("energy3d", {"u": u})
        (bucket,) = srv.metrics.snapshot()["buckets"]
    assert "('Ni', 20)" in bucket and "('Nj', 7)" in bucket
    assert torch.equal(out["energy"],
                       _ref("energy3d", {"u": u}, backend)["energy"])


def test_multiple_programs_one_engine():
    rng = _rng()
    u2 = rng.standard_normal((9, 17)).astype(np.float32)
    u3 = rng.standard_normal((5, 9, 17)).astype(np.float32)
    with _serve(["laplace5", "heat3d"], max_wait_ms=1.0) as srv:
        ta = srv.submit("laplace5", {"cell": u2})
        tb = srv.submit("heat3d", {"u": u3})
        out_a, out_b = ta.result(60), tb.result(60)
    assert torch.equal(out_a["lap"], _ref("laplace5", {"cell": u2})["lap"])
    assert torch.equal(out_b["heat"], _ref("heat3d", {"u": u3})["heat"])


def test_metrics_snapshot_schema():
    u = _rng().standard_normal((9, 17)).astype(np.float32)
    with _serve(["laplace5"], max_wait_ms=1.0) as srv:
        srv.serve("laplace5", {"cell": u})
        snap = srv.metrics.snapshot()
    assert snap["requests"] == 1
    assert snap["requests_per_s"] > 0
    for dist in (snap["latency_ms"], snap["queue_wait_ms"]):
        assert set(dist) == {"p50", "p99", "mean", "max"}
        assert dist["p50"] <= dist["p99"] <= dist["max"]
    assert set(snap["compiles"]) == {"count", "disk_hits", "total_ms"}
    assert snap["batch_size"]["max"] == 1


def test_engine_rejects_bad_configuration():
    with pytest.raises(ValueError, match="batch-safe"):
        _serve(["laplace5"], backend="auto")
    prog = _prog("laplace5")
    prog.goals[0].store_as = None
    with pytest.raises(ValueError, match="store_as"):
        PlanServe({"laplace5": prog}, device="cpu")
    with pytest.raises(ValueError, match="max_batch"):
        _serve(["laplace5"], max_batch=0)


def test_unknown_program_and_closed_engine():
    srv = _serve(["laplace5"], max_wait_ms=1.0)
    with pytest.raises(ValueError, match="unknown program"):
        srv.submit("nope", {})
    srv.close()
    srv.close()  # idempotent
    with pytest.raises(RuntimeError, match="closed"):
        srv.submit("laplace5", {"cell": np.zeros((4, 4), np.float32)})


def test_close_drains_queued_requests():
    rng = _rng()
    srv = _serve(["laplace5"], max_batch=2, max_wait_ms=500.0)
    inputs = [rng.standard_normal((9, 17)).astype(np.float32)
              for _ in range(3)]
    tickets = [srv.submit("laplace5", {"cell": u}) for u in inputs]
    t0 = time.perf_counter()
    srv.close()
    assert time.perf_counter() - t0 < 60
    for u, t in zip(inputs, tickets):
        assert torch.equal(t.result(1)["lap"],
                           _ref("laplace5", {"cell": u})["lap"])


def test_failing_batch_fails_its_tickets(monkeypatch):
    """A batch that raises fails every ticket in it with that error;
    nothing retries on another backend, and the engine serves on."""
    import repro_torch.serve.plans as plans
    u = _rng().standard_normal((9, 17)).astype(np.float32)
    with _serve(["laplace5"], max_wait_ms=1.0) as srv:
        real = plans.compile_batched

        def broken(*a, **k):
            raise RuntimeError("CUDA error: an illegal memory access")

        monkeypatch.setattr(plans, "compile_batched", broken)
        t = srv.submit("laplace5", {"cell": u})
        with pytest.raises(RuntimeError, match="illegal memory access"):
            t.result(60)
        monkeypatch.setattr(plans, "compile_batched", real)
        out = srv.serve("laplace5", {"cell": u}, timeout=60)
    assert torch.equal(out["lap"], _ref("laplace5", {"cell": u})["lap"])


# ---------------------------------------------------------------------------
# Against the reference's PlanServe
# ---------------------------------------------------------------------------

_MIX = [("laplace5", {"cell": (11, 19)}),
        ("hydro1d", {"rho": (6, 21), "mom": (6, 21)}),
        ("normalization", {"u": (9, 14)}),
        ("cosmo", {"u": (3, 11, 13)}),
        ("row_sum", {"u": (7, 20)})]


@pytest.mark.parametrize("backend", CPU_BACKENDS)
def test_matches_reference_planserve(backend):
    """The same mixed request stream through the port's PlanServe and
    the reference's (``backend="jax"``, the JAX package's emitter),
    within ``atol=2e-4, rtol=1e-3``."""
    from repro.core.programs import ALL_PROGRAMS as REF_PROGRAMS
    from repro.serve.plans import PlanServe as RefPlanServe

    rng = _rng()
    reqs = []
    for name, shapes in _MIX:
        arrs = {k: rng.standard_normal(s).astype(np.float32)
                for k, s in shapes.items()}
        if name == "hydro1d":
            arrs["rho"] = arrs["rho"] ** 2 + 1.0
        reqs.append((name, arrs))
    names = [n for n, _ in _MIX]
    with RefPlanServe({n: REF_PROGRAMS[n]() for n in names}, backend="jax",
                      max_wait_ms=1.0) as ref, \
            _serve(names, backend=backend, max_wait_ms=1.0) as srv:
        want = [ref.serve(n, a, timeout=120) for n, a in reqs]
        got = [srv.serve(n, a, timeout=120) for n, a in reqs]
    for (name, _), g, w in zip(reqs, got, want):
        assert set(g) == set(w)
        for k in w:
            np.testing.assert_allclose(g[k].numpy(), np.asarray(w[k]),
                                       atol=2e-4, rtol=1e-3,
                                       err_msg=f"{name}:{k}")


# ---------------------------------------------------------------------------
# Spawned workers sharing one plan cache
# ---------------------------------------------------------------------------

def test_workers_share_one_plan_cache(tmp_path):
    from repro_torch.serve.workers import ServeWorker, WorkerPool

    u = np.random.default_rng(3).standard_normal((9, 17)).astype(np.float32)
    ref = _ref("laplace5", {"cell": u})["lap"].numpy()
    with ServeWorker(["laplace5"], device="cpu", cache_dir=tmp_path,
                     max_wait_ms=1.0) as w:
        np.testing.assert_array_equal(
            w.serve("laplace5", {"cell": u})["lap"], ref)
        cold = w.metrics()
    assert cold["compiles"]["count"] == 1
    assert cold["compiles"]["disk_hits"] == 0
    assert len(list(tmp_path.glob("*.json"))) == 1

    with WorkerPool(2, ["laplace5"], device="cpu", cache_dir=tmp_path,
                    max_wait_ms=1.0) as pool:
        for _ in range(4):
            np.testing.assert_array_equal(
                pool.serve("laplace5", {"cell": u})["lap"], ref)
        snaps = pool.close()
    assert len(snaps) == 2
    for snap in snaps:
        assert snap["requests"] == 2
        assert snap["compiles"]["disk_hits"] == snap["compiles"]["count"] == 1


def test_worker_survives_bad_requests(tmp_path):
    from repro_torch.serve.workers import ServeWorker

    u = np.random.default_rng(5).standard_normal((9, 17)).astype(np.float32)
    with ServeWorker(["laplace5"], device="cpu", cache_dir=tmp_path,
                     max_wait_ms=1.0) as w:
        with pytest.raises(RuntimeError, match="unknown program"):
            w.serve("nope", {})
        with pytest.raises(RuntimeError, match="expects input arrays"):
            w.serve("laplace5", {})
        out = w.serve("laplace5", {"cell": u})
    np.testing.assert_array_equal(out["lap"],
                                  _ref("laplace5", {"cell": u})["lap"].numpy())
