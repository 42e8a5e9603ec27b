"""The port's on-disk AOT plan cache (``repro_torch.core.plancache``):
content addressing, atomic durable entries, corruption tolerance, the
torch/CUDA/port version header, LRU bounds, write locking, and the
headline behavior — a plan serialized in one process loads in a *fresh
subprocess* and executes with oracle-identical output without ever
invoking the planner.  The cases of ``tests/test_plancache.py`` that do
not reach Pallas, on the port's ``interp_torch`` (and, where nothing
runs, the ``"cuda"`` interpreter: compiling builds no kernel).
"""
import fcntl
import json
import os
import pathlib
import subprocess
import sys
import textwrap
import threading

import numpy as np
import pytest
import torch

import repro_torch.core.engine as engine
from repro_torch.core import (Generated, PallasGenerated, PlanCache,
                              analyze_storage, build_dataflow, build_unfused,
                              clear_compile_cache, compile_program,
                              fuse_inest_dag, infer, plan_pallas,
                              program_plan_key)
from repro_torch.core.programs import (heat3d_program, laplace5_program,
                                       normalization_program,
                                       row_sum_program)

ROOT = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def _fresh_cache():
    clear_compile_cache()
    yield
    clear_compile_cache()


def _plan_of(program):
    idag = infer(program)
    return plan_pallas(analyze_storage(fuse_inest_dag(build_dataflow(idag))),
                       idag)


def _compile(prog, backend="interp_torch", **kw):
    return compile_program(prog, backend=backend, device="cpu", **kw)


# ---------------------------------------------------------------------------
# The store itself
# ---------------------------------------------------------------------------

def test_put_get_roundtrip(tmp_path):
    prog = heat3d_program()
    kplan = _plan_of(prog)
    cache = PlanCache(tmp_path)
    key = program_plan_key(prog)
    assert cache.get(key) is None
    assert cache.put(key, kplan)
    loaded = cache.get(key)
    assert loaded == kplan
    assert loaded.cache_key() == kplan.cache_key()
    assert len(cache) == 1


def test_key_distinguishes_kernel_bodies(tmp_path):
    assert program_plan_key(laplace5_program()) \
        != program_plan_key(heat3d_program())
    p1, p2 = laplace5_program(), laplace5_program("laplace5_b")
    assert program_plan_key(p1) != program_plan_key(p2)
    assert program_plan_key(laplace5_program()) \
        == program_plan_key(laplace5_program())


def test_key_is_stable_across_processes():
    """The digest folds in code objects by marshal bytes, never by
    address: a fresh interpreter computes the same key."""
    code = ("from repro_torch.core import program_plan_key\n"
            "from repro_torch.core.programs import cosmo_program\n"
            "print(program_plan_key(cosmo_program()))\n")
    from repro_torch.core.programs import cosmo_program
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300,
                         env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == program_plan_key(cosmo_program())


def test_key_folds_in_the_torch_and_port_versions(monkeypatch):
    import repro_torch.core as core
    key = program_plan_key(laplace5_program())
    monkeypatch.setattr(torch, "__version__", "0.0.0-other")
    assert program_plan_key(laplace5_program()) != key
    monkeypatch.undo()
    monkeypatch.setattr(core, "__version__", "0.0.0-other")
    assert program_plan_key(laplace5_program()) != key
    monkeypatch.undo()
    assert program_plan_key(laplace5_program()) == key


def test_corrupt_entry_is_a_miss_and_deleted(tmp_path):
    prog = laplace5_program()
    cache = PlanCache(tmp_path)
    key = program_plan_key(prog)
    cache.put(key, _plan_of(prog))
    path = tmp_path / f"{key}.json"
    path.write_text("{definitely not json")
    assert cache.get(key) is None
    assert not path.exists()


def test_version_header_mismatch_is_a_miss(tmp_path):
    prog = laplace5_program()
    cache = PlanCache(tmp_path)
    key = program_plan_key(prog)
    cache.put(key, _plan_of(prog))
    path = tmp_path / f"{key}.json"
    good = path.read_text()
    assert set(json.loads(good)) == {"torch", "cuda", "repro_torch", "plan"}
    for field, other in (("torch", "0.0.0-other"), ("cuda", "0.0"),
                         ("repro_torch", "0.0.0-other")):
        payload = json.loads(good)
        payload[field] = other
        path.write_text(json.dumps(payload))
        assert cache.get(key) is None
        assert not path.exists()  # condemned by its own header
    path.write_text(good)
    assert cache.get(key) is not None


def test_schema_mismatch_is_a_miss(tmp_path):
    prog = laplace5_program()
    cache = PlanCache(tmp_path)
    key = program_plan_key(prog)
    cache.put(key, _plan_of(prog))
    payload = json.loads((tmp_path / f"{key}.json").read_text())
    payload["plan"]["schema"] = 9999
    (tmp_path / f"{key}.json").write_text(json.dumps(payload))
    assert cache.get(key) is None
    assert not (tmp_path / f"{key}.json").exists()


def test_lru_eviction_bounds_entries(tmp_path):
    cache = PlanCache(tmp_path, max_entries=2)
    progs = [laplace5_program(), heat3d_program(), row_sum_program()]
    keys = [program_plan_key(p) for p in progs]
    for p, k in zip(progs[:2], keys[:2]):
        cache.put(k, _plan_of(p))
    os.utime(tmp_path / f"{keys[0]}.json", (1, 1))  # make entry 0 oldest
    cache.put(keys[2], _plan_of(progs[2]))
    assert len(cache) == 2
    assert cache.get(keys[0]) is None  # oldest evicted
    assert cache.get(keys[2]) is not None


def test_mid_get_eviction_degrades_to_a_miss(tmp_path, monkeypatch):
    """Another process's eviction sweep can unlink the entry between
    get's load and its ``os.utime``: a miss, never a hit on a plan the
    cache no longer holds."""
    prog = laplace5_program()
    cache = PlanCache(tmp_path)
    key = program_plan_key(prog)
    assert cache.put(key, _plan_of(prog))
    path = tmp_path / f"{key}.json"
    real_utime = os.utime

    def evict_then_touch(p, *a, **kw):
        pathlib.Path(p).unlink()
        return real_utime(p, *a, **kw)

    monkeypatch.setattr(os, "utime", evict_then_touch)
    assert cache.get(key) is None
    monkeypatch.undo()
    assert not path.exists()
    assert cache.put(key, _plan_of(prog))
    assert cache.get(key) is not None


def test_utime_denied_is_still_a_hit(tmp_path, monkeypatch):
    prog = laplace5_program()
    cache = PlanCache(tmp_path)
    key = program_plan_key(prog)
    assert cache.put(key, _plan_of(prog))

    def deny_touch(p, *a, **kw):
        raise PermissionError("utime denied")

    monkeypatch.setattr(os, "utime", deny_touch)
    assert cache.get(key) is not None


def test_atomic_write_leaves_no_temp_files(tmp_path):
    cache = PlanCache(tmp_path)
    cache.put(program_plan_key(laplace5_program()),
              _plan_of(laplace5_program()))
    assert list(tmp_path.glob("*.tmp")) == []
    assert sorted(p.name for p in tmp_path.glob("*") if p.name != ".lock") \
        == sorted(p.name for p in tmp_path.glob("*.json"))
    assert len(list(tmp_path.glob("*.json"))) == 1


def test_put_survives_filesystem_failures(tmp_path, monkeypatch):
    cache = PlanCache(tmp_path)
    kplan = _plan_of(laplace5_program())
    key = program_plan_key(laplace5_program())
    monkeypatch.setattr(os, "replace",
                        lambda *a: (_ for _ in ()).throw(OSError("ENOSPC")))
    assert cache.put(key, kplan) is False
    assert [p.name for p in tmp_path.glob("*") if p.name != ".lock"] == []


def test_evict_tolerates_racing_unlinks(tmp_path, monkeypatch):
    cache = PlanCache(tmp_path, max_entries=1)
    cache.put(program_plan_key(laplace5_program()),
              _plan_of(laplace5_program()))
    key2 = program_plan_key(heat3d_program())
    kplan2 = _plan_of(heat3d_program())
    real_stat = pathlib.Path.stat
    raced = set()

    def racing_stat(self, **kw):
        if self.suffix == ".json" and str(self) not in raced:
            raced.add(str(self))
            try:
                os.unlink(self)
            except FileNotFoundError:
                pass
            raise FileNotFoundError(self)
        return real_stat(self, **kw)

    monkeypatch.setattr(pathlib.Path, "stat", racing_stat)
    assert cache.put(key2, kplan2)


def test_write_lock_serializes_puts(tmp_path):
    """``put`` holds an exclusive ``flock`` on ``.lock`` across its write
    and eviction sweep: a second writer blocks until it is released."""
    cache = PlanCache(tmp_path)
    key = program_plan_key(laplace5_program())
    kplan = _plan_of(laplace5_program())
    fd = os.open(tmp_path / ".lock", os.O_CREAT | os.O_RDWR)
    fcntl.flock(fd, fcntl.LOCK_EX)
    done = threading.Event()

    def put():
        cache.put(key, kplan)
        done.set()

    t = threading.Thread(target=put)
    t.start()
    assert not done.wait(0.3)  # blocked on the held lock
    os.close(fd)
    assert done.wait(30)
    t.join()
    assert cache.get(key) is not None


def test_concurrent_writers_keep_the_bound_and_whole_entries(tmp_path):
    progs = [laplace5_program(), heat3d_program(), row_sum_program(),
             normalization_program()]
    plans = [(program_plan_key(p), _plan_of(p)) for p in progs]
    errors = []

    def writer(k):
        try:
            cache = PlanCache(tmp_path, max_entries=2)
            for _ in range(5):
                for key, kplan in plans[k % 2::2]:
                    assert cache.put(key, kplan)
        except Exception as err:
            errors.append(err)

    threads = [threading.Thread(target=writer, args=(k,)) for k in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors
    cache = PlanCache(tmp_path, max_entries=2)
    assert len(cache) <= 2
    for path in tmp_path.glob("*.json"):
        assert cache.get(path.stem) is not None
    assert list(tmp_path.glob("*.tmp")) == []


# ---------------------------------------------------------------------------
# Engine integration: L2 under the in-memory caches
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["interp_torch", "auto"])
def test_warm_compile_skips_planner_and_pipeline(tmp_path, monkeypatch,
                                                 backend):
    """With a warmed cache dir, compile_program never invokes
    plan_pallas *or* the analysis pipeline (``infer`` itself raises) —
    and the result is bit-identical to the cold compile's and matches
    the unfused oracle."""
    prog = laplace5_program()
    u = np.random.default_rng(0).standard_normal((8, 12)).astype(np.float32)
    ref = build_unfused(prog, device="cpu").fn(cell=u)["lap"]
    cold = _compile(prog, backend, plan_cache_dir=tmp_path).fn(cell=u)["lap"]
    clear_compile_cache()

    def boom(*a, **k):
        raise AssertionError("analysis ran despite a warm plan cache")

    monkeypatch.setattr(engine, "infer", boom)
    monkeypatch.setattr(engine, "plan_pallas", boom)
    monkeypatch.setattr(engine, "_build_plan", boom)
    gen = _compile(prog, backend, plan_cache_dir=tmp_path)
    assert isinstance(gen, PallasGenerated) and gen.plan is None
    assert gen.interpreter == "interp_torch"
    assert torch.equal(gen.fn(cell=u)["lap"], cold)
    np.testing.assert_allclose(gen.fn(cell=u)["lap"].numpy(), ref.numpy(),
                               atol=1e-5, rtol=1e-5)
    with pytest.raises(ValueError, match="on-disk plan cache"):
        gen.schedule


def test_plan_cache_dir_from_the_environment(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_PLAN_CACHE_DIR", str(tmp_path))
    _compile(laplace5_program())
    assert len(PlanCache(tmp_path)) == 1


def test_auto_backend_uses_warm_single_nest_plan(tmp_path, monkeypatch):
    prog = heat3d_program()
    _compile(prog, "cuda", plan_cache_dir=tmp_path)
    clear_compile_cache()
    monkeypatch.setattr(engine, "_build_plan",
                        lambda *a: pytest.fail("pipeline ran"))
    gen = _compile(prog, "auto", plan_cache_dir=tmp_path)
    assert isinstance(gen, PallasGenerated)


def test_auto_backend_ignores_warm_split_plan(tmp_path):
    """A pre-warmed multi-nest plan must not flip auto routing: split
    schedules stay on the emitter unless registered as a measured win."""
    prog = normalization_program()
    _compile(prog, plan_cache_dir=tmp_path)
    assert len(PlanCache(tmp_path)) == 1
    clear_compile_cache()
    gen = _compile(prog, "auto", plan_cache_dir=tmp_path)
    assert isinstance(gen, Generated)


def test_cold_compile_fills_the_cache_dir(tmp_path):
    prog = row_sum_program()
    assert len(PlanCache(tmp_path)) == 0
    _compile(prog, plan_cache_dir=tmp_path)
    assert len(PlanCache(tmp_path)) == 1
    entry = next(tmp_path.glob("*.json"))
    entry.write_text("oops")
    clear_compile_cache()
    gen = _compile(prog, plan_cache_dir=tmp_path)
    assert isinstance(gen, PallasGenerated) and gen.plan is not None
    assert len(PlanCache(tmp_path)) == 1


def test_memory_hit_backfills_the_cache_dir(tmp_path):
    prog = laplace5_program()
    _compile(prog)  # plain compile first
    assert len(PlanCache(tmp_path)) == 0
    g = _compile(prog, plan_cache_dir=tmp_path)
    assert g.plan is not None
    assert len(PlanCache(tmp_path)) == 1
    assert PlanCache(tmp_path).get(program_plan_key(prog)) is not None


def test_disk_restored_gen_does_not_pollute_plain_compiles(tmp_path):
    prog = laplace5_program()
    _compile(prog, plan_cache_dir=tmp_path)
    clear_compile_cache()
    g_disk = _compile(prog, plan_cache_dir=tmp_path)
    assert g_disk.plan is None
    g_plain = _compile(prog)
    assert g_plain.plan is not None
    assert g_plain.schedule.n_toplevel() == 1
    assert g_plain is g_disk and g_disk.plan is not None


def test_missing_step_builder_is_a_miss_that_keeps_the_entry(tmp_path):
    """A process that has not (yet) registered a plan's step builders
    gets a miss WITHOUT destroying the shared entry."""
    from repro_torch.core import (Program, axiom, goal, kernel,
                                  register_step_builder,
                                  unregister_step_builder)

    def half(x):
        return 0.5 * x

    def build():
        register_step_builder("pc_keep:s", half)
        return Program(
            rules=[kernel("s", [("a", "u?[j?][i?]")],
                          [("o", "half(u?[j?][i?])")], fn=half)],
            axioms=[axiom("u[j?][i?]", j="Nj", i="Ni")],
            goals=[goal("half(u[j][i])", store_as="half")],
            loop_order=("j", "i"), name="pc_keep")

    prog = build()
    cache = PlanCache(tmp_path)
    key = program_plan_key(prog)
    try:
        assert cache.put(key, _plan_of(prog))
    finally:
        unregister_step_builder("pc_keep:s")
    assert cache.get(key) is None
    assert (tmp_path / f"{key}.json").exists()
    build()
    try:
        assert cache.get(key) is not None
    finally:
        unregister_step_builder("pc_keep:s")


def test_unwritable_cache_dir_degrades_to_cold_compile(tmp_path):
    blocker = tmp_path / "blocker"
    blocker.write_text("")
    gen = _compile(laplace5_program(), plan_cache_dir=blocker / "cache")
    assert isinstance(gen, PallasGenerated) and gen.plan is not None


# ---------------------------------------------------------------------------
# The headline: cross-process AOT compile with the planner booby-trapped
# ---------------------------------------------------------------------------

_CHILD = textwrap.dedent("""\
    import numpy as np
    import repro_torch.core.engine as engine
    from repro_torch.core.programs import {builder}

    def boom(*a, **k):
        raise AssertionError("planner invoked in the warm process")
    engine.plan_pallas = boom
    engine._build_plan = boom
    engine.infer = boom

    prog = {builder}()
    gen = engine.compile_program(prog, backend="interp_torch", device="cpu",
                                 plan_cache_dir={cache_dir!r})
    assert gen.plan is None, "expected a disk-restored plan"
    u = np.random.default_rng(7).standard_normal({shape}).astype(np.float32)
    out = gen.fn(**{{ {arr!r}: u }})[{out!r}]
    from repro_torch.core.unfused import build_unfused
    ref = build_unfused(prog, device="cpu").fn(**{{ {arr!r}: u }})[{out!r}]
    assert np.allclose(out.numpy(), ref.numpy(),
                       atol=1e-5, rtol=1e-5), "output mismatch"
    print("AOT-OK")
""")


@pytest.mark.parametrize("builder,arr,out,shape", [
    ("laplace5_program", "cell", "lap", (8, 12)),
    ("heat3d_program", "u", "heat", (5, 8, 12)),
])
def test_cross_process_aot_compile(tmp_path, builder, arr, out, shape):
    import repro_torch.core.programs as programs
    _compile(getattr(programs, builder)(), plan_cache_dir=tmp_path)
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src") + (
        os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    code = _CHILD.format(builder=builder, cache_dir=str(tmp_path),
                         shape=shape, arr=arr, out=out)
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert "AOT-OK" in res.stdout
