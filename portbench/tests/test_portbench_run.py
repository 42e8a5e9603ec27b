"""Whole runs of every cell on the CPU at tiny sizes (the harness's look
for a card skipped): the result line's shape, the closed loop through
PlanServe, and ``correct`` against the sound program, its control and the
faults a cell can have."""
import json
import time

import pytest
import torch

from portbench import harness

#: Tiny grids and few clients: the plain interpreter on the CPU.
SMALL = {
    "cosmo-step": ({"Nk": 2, "Nj": 12, "Ni": 20}, None),
    "hydro1d-step": ({"Nj": 8, "Ni": 64}, None),
    "cosmo-ens": ({"Nk": 2, "Nj": 12, "Ni": 20},
                  {"clients": 3, "serve": {"max_batch": 3, "max_wait_ms": 2.0,
                                           "quantum": 32}}),
    "hydro1d-ens": ({"Nj": 8, "Ni": 64},
                    {"clients": 4, "serve": {"max_batch": 4,
                                             "max_wait_ms": 2.0,
                                             "quantum": 32}}),
}
CELLS = sorted(SMALL)
SEED = 2**31 + 11
GOAL = {"cosmo": ("u", "unew"), "hydro1d": ("rho", "rnew")}


#: BENCHMARK.json with the cells held out of it (``held.json``).
BENCH = harness.with_held(harness.load_benchmark())


def run(cell, trace=False, seconds=0.4, **kw):
    dims, mix = SMALL[cell]
    return harness.run_cell(cell, SEED, seconds, trace,
                            t_start=time.perf_counter(), device="cpu",
                            dims=dims, mix=mix, bench=BENCH, **kw)


def config_of(cell):
    return next(c["config"] for c in BENCH["workloads"] if c["name"] == cell)


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct_and_line_has_its_shape(cell):
    line = run(cell)
    assert line["correct"] is True
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "checks"
    assert line["failed"] == 0 and line["attempted"] >= 1
    want = {m["name"]: m["unit"]
            for m in harness.metric_entries(BENCH, cell, False)}
    assert {k: v["unit"] for k, v in line["metrics"].items()} == want
    assert all(v["value"] > 0 for v in line["metrics"].values())
    dev = line["device"]
    assert set(dev) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert dev["count"] == 1
    checks = line["checks"]
    assert checks["rel_l2"]["value"] <= checks["rel_l2"]["limit"]
    assert checks["failed"] == {"value": 0, "limit": 0}
    json.dumps(line)


@pytest.mark.parametrize("cell", ["cosmo-step", "hydro1d-ens"])
def test_traced_run_reports_per_layer_metrics_only(cell):
    line = run(cell, trace=True, seconds=0.6)
    names = {m["name"] for m in harness.metric_entries(BENCH, cell, True)}
    assert set(line["metrics"]) <= names
    # no device trace on the CPU: the trace's readers find nothing
    assert not {"copy_us", "k1_roofline", "idle_share",
                "step_mfu"} & set(line["metrics"])
    assert "plan_ms" in line["metrics"]
    assert {"busy_s", "window_s"} <= set(line["device"])
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    assert list(line)[-1] == "checks"


def test_closed_loop_steps_in_lockstep():
    line = run("hydro1d-ens", trace=True, seconds=0.6)
    clients = SMALL["hydro1d-ens"][1]["clients"]
    assert line["attempted"] % clients == 0
    assert 1 <= line["metrics"]["batch_mean"]["value"] <= clients
    assert line["metrics"]["queue_ms"]["value"] >= 0


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails(cell):
    line = run(cell, control=True)
    assert line["correct"] is False
    assert line["checks"]["rel_l2"]["value"] > 3e-4


def _wrap_single(monkeypatch, change):
    import repro_torch.core as core
    real = core.compile_program

    def compile_program(program, *a, **kw):
        gen = real(program, *a, **kw)

        class Broken:
            def fn(self, **arrays):
                return change(gen.fn, arrays)
        return Broken()
    monkeypatch.setattr(core, "compile_program", compile_program)


def _wrap_batched(monkeypatch, change):
    import repro_torch.serve.plans as plans
    real = plans.compile_batched

    def compile_batched(program, *a, **kw):
        gen = real(program, *a, **kw)
        return plans.BatchedGenerated(
            gen.gen, lambda arrays: change(gen.fn, arrays),
            backend=gen.backend)
    monkeypatch.setattr(plans, "compile_batched", compile_batched)


def _unchanged(cell):
    src, dst = GOAL[config_of(cell)]
    return lambda fn, arrays: {dst: arrays[src].clone()}


def _alter(out: torch.Tensor) -> None:
    """Add 1 to one output inside the goal's region (j = i = 5)."""
    out[(0,) * (out.dim() - 2) + (5, 5)] += 1.0


@pytest.mark.parametrize("cell", ["cosmo-step", "hydro1d-step"])
def test_fault_step_returns_its_state_unchanged(monkeypatch, cell):
    _wrap_single(monkeypatch, _unchanged(cell))
    assert run(cell)["correct"] is False


@pytest.mark.parametrize("cell", ["cosmo-step", "hydro1d-step"])
def test_fault_answer_altered_where_produced_step(monkeypatch, cell):
    def change(fn, arrays):
        out = fn(**arrays)
        for v in out.values():
            _alter(v)
        return out
    _wrap_single(monkeypatch, change)
    assert run(cell)["correct"] is False


def test_fault_non_finite_output_keeps_the_line_strict_json(monkeypatch):
    def change(fn, arrays):
        out = fn(**arrays)
        for v in out.values():
            v[(0,) * (v.dim() - 2) + (5, 5)] = float("nan")
        return out
    _wrap_single(monkeypatch, change)
    line = run("cosmo-step")
    assert line["correct"] is False
    assert line["checks"]["rel_l2"]["value"] is None
    json.dumps(line, allow_nan=False)


@pytest.mark.parametrize("cell", ["cosmo-ens", "hydro1d-ens"])
def test_fault_request_returns_its_input(monkeypatch, cell):
    _wrap_batched(monkeypatch, _unchanged(cell))
    assert run(cell)["correct"] is False


@pytest.mark.parametrize("cell", ["cosmo-ens", "hydro1d-ens"])
def test_fault_half_the_batch_left_out(monkeypatch, cell):
    """The first half of each micro-batch computed, the rest given the
    mean of those outputs."""
    def change(fn, arrays):
        b = len(next(iter(arrays.values())))
        h = max(1, b // 2)
        out = fn({k: v[:h] for k, v in arrays.items()})
        return {k: torch.cat([v, v.mean(0, keepdim=True).expand(
            b - h, *v.shape[1:])]) for k, v in out.items()}
    _wrap_batched(monkeypatch, change)
    assert run(cell)["correct"] is False


@pytest.mark.parametrize("cell", ["cosmo-ens", "hydro1d-ens"])
def test_fault_answer_altered_where_produced_ens(monkeypatch, cell):
    def change(fn, arrays):
        out = fn(arrays)
        for v in out.values():
            _alter(v[0])
        return out
    _wrap_batched(monkeypatch, change)
    assert run(cell)["correct"] is False


def test_set_environment_puts_the_caches_in_the_checkout():
    import os
    harness.set_environment()
    for key, path in harness.CACHE_ENV.items():
        assert os.environ[key] == str(path)
        assert path.is_relative_to(harness.ROOT)
    assert os.environ["USE_FLAX"] == "0"


def test_main_refuses_without_a_card(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = harness.main(["--workload", "cosmo-step", "--seed", "1",
                       "--seconds", "1", "--trace", "0"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == ""
    assert "CUDA" in out.err


def test_main_refuses_an_unknown_cell(capsys):
    rc = harness.main(["--workload", "nope", "--seed", "1", "--seconds", "1"])
    assert rc != 0 and capsys.readouterr().out == ""


def test_forbidden_modules_compare_top_level_names(monkeypatch):
    import sys
    import types
    monkeypatch.setitem(sys.modules, "repro_torch_lookalike",
                        types.ModuleType("repro_torch_lookalike"))
    assert harness.forbidden_modules() == [
        m for m in harness.forbidden_modules() if m.split(".")[0] in
        {"jax", "jaxlib", "flax", "repro"}]
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("jax"))
    assert "jax.numpy" in harness.forbidden_modules()
    assert "repro_torch_lookalike" not in harness.forbidden_modules()


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_at_the_cells_size_on_the_card(cuda_device, cell):
    """The control on three seeds and the sound program on one, at the
    cell's own size and load (``portbench.readings``)."""
    from portbench.readings import read
    r = read(cell, [7001], [7101, 7102, 7103], 2.0, bench=BENCH)
    assert all(x["correct"] for x in r["sound"])
    assert not any(x["correct"] for x in r["control"])
    assert r["upper"] >= 3 * r["lower"]
