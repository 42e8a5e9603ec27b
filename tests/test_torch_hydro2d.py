"""The port's own program ``hydro2d`` (HydroC's split step,
``repro_torch.core.hydro2d``) on the CPU: against the benchmark's plain
float64 reference (``portbench/reference/hydro2d.py``, which imports
nothing of the port) in float64 and float32, its invariants (a uniform
state is a fixed point; the x and y sweeps are one operator, transposed),
the plan the planner gives it, and the counters of K1's loaded sources
(on the card)."""
import numpy as np
import pytest
import torch

from portbench.harness import rel_l2
from portbench.metrics import _yardstick
from portbench.reference import hydro2d as ref
from repro_torch import obs
from repro_torch.core import (ALL_PROGRAMS, PORT_ONLY, build_unfused,
                              compile_program)
from repro_torch.core.hydro2d import OUTPUTS, STATE, hydro2d_program

#: Operations of one grid point of the step, as the yardstick counts the
#: reference's bodies (a selection free, a square root one): each sweep's
#: constoprim 9, eos 7, four slopes 19 each, trace 79, riemann 505
#: (ten Newton iterations of 38), cmpflx 13, update 12.
FLOPS_PER_POINT = 1402
#: float32 against the float64 reference: each output point comes out of
#: about 1,400 float32 operations, ten Newton iterations among them, and
#: reads 6.7e-8 to 7.4e-8 in relative L2 at (37, 41) over six seeds (7.0e-8
#: at 10,000 x 10,000 on the card); the limit leaves seven times that.
FLOAT32_RTOL = 5e-7


def state(nj, ni, seed, dtype=torch.float64):
    """A seeded state as the benchmark draws it: ``rho = x*x + 1``,
    ``rhou``, ``rhov`` standard normal, ``E = 20 + x*x``."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((4, nj, ni), generator=g, dtype=torch.float64)
    return {"rho": (x[0] ** 2 + 1).to(dtype), "rhou": x[1].to(dtype),
            "rhov": x[2].to(dtype), "E": (x[3] ** 2 + 20).to(dtype)}


def step(arrays, order="xy", dtype=torch.float64):
    prog = hydro2d_program(order=order) if order != "xy" \
        else ALL_PROGRAMS["hydro2d"]()
    return compile_program(prog, backend="interp_torch", device="cpu",
                           dtype=dtype).fn(**arrays)


def test_registered_as_the_ports_own():
    assert PORT_ONLY == ("hydro2d", "courant", "hydroc")
    assert ALL_PROGRAMS["hydro2d"] is hydro2d_program


@pytest.mark.parametrize("shape", [(13, 21), (40, 33), (1030, 9)])
def test_float64_matches_the_reference(shape):
    """1030 rows cross the reference's blocks of 512 output rows."""
    a = state(*shape, seed=sum(shape))
    got, want = step(a), ref.forward(a)
    assert set(got) == set(want) == set(OUTPUTS)
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=1e-12, atol=1e-12,
                                   msg=k)
        assert bool((want[k][:2] == 0).all() and (want[k][:, -2:] == 0).all())


@pytest.mark.parametrize("seed", [0, 1])
def test_float32_within_its_rounding(seed):
    a = state(37, 41, seed, torch.float32)
    got = step(a, dtype=torch.float32)
    x = {k: v.double() for k, v in a.items()}
    want, skip = ref.forward(x), ref.undecided(x)
    for k in want:
        assert got[k].dtype == torch.float32
        assert rel_l2(got[k], want[k], skip[k]) <= FLOAT32_RTOL, k


def test_unfused_oracle_agrees():
    a = state(11, 17, 3)
    got, want = step(a), build_unfused(ALL_PROGRAMS["hydro2d"]()).fn(**a)
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("u,v", [(0.0, 0.0), (0.7, -1.3)])
def test_uniform_state_is_a_fixed_point(u, v):
    """Equal states on both sides of every interface give equal fluxes,
    so the step leaves the interior as it was (up to rounding)."""
    nj, ni = 9, 12
    full = lambda x: torch.full((nj, ni), x, dtype=torch.float64)  # noqa: E731
    rho, p = 1.3, 2.1
    a = {"rho": full(rho), "rhou": full(rho * u), "rhov": full(rho * v),
         "E": full(p / 0.4 + 0.5 * rho * (u * u + v * v))}
    got = step(a)
    for k, name in zip(OUTPUTS, STATE):
        torch.testing.assert_close(got[k][2:-2, 2:-2], a[name][2:-2, 2:-2],
                                   rtol=1e-13, atol=1e-13, msg=k)


def test_transposed_step_is_the_transposed_y_then_x_step():
    """The x sweep of a transposed state, its momenta swapped, is the y
    sweep of the state: one operator along either axis."""
    a = state(14, 19, 5)
    t = {"rho": a["rho"].T, "rhou": a["rhov"].T, "rhov": a["rhou"].T,
         "E": a["E"].T}
    got = step({k: v.contiguous() for k, v in t.items()})
    want = step(a, order="yx")
    pairs = {"rnew": "rnew", "unew": "vnew", "vnew": "unew", "enew": "enew"}
    for k, w in pairs.items():
        torch.testing.assert_close(got[k], want[w].T, rtol=1e-12,
                                   atol=1e-12, msg=k)
    with pytest.raises(ValueError, match="order"):
        hydro2d_program(order="xx")


def test_reference_bodies_count_their_operations():
    assert len(ref.BODIES) == 20
    assert _yardstick.flops_per_point(ref.BODIES) == FLOPS_PER_POINT


def test_one_fused_nest_with_the_x_state_in_rolling_rows():
    """The planner fuses both sweeps into one (j, i) nest: the x sweep runs
    two rows ahead (lead 2) with its locals in the row, and the y sweep
    reads the x sweep's state from a 3-row rolling window."""
    kplan = compile_program(ALL_PROGRAMS["hydro2d"](), backend="interp_torch",
                            device="cpu").kernel_plan
    call, = kplan.calls
    windows = {w.name: w.stages for w in call.windows}
    assert {f"b_x_{a}_rho" for a in STATE} <= set(windows)
    assert all(windows[f"b_x_{a}_rho"] == 3 for a in STATE)
    leads = {s.op: s.lead for s in call.steps}
    assert leads["x_update"] == 2 and leads["y_update"] == 0
    # same-row locals are read at their producer's lead
    for s in call.steps:
        for rd in s.reads:
            if rd.src.startswith("local:"):
                assert rd.j_off == s.lead


@pytest.mark.cuda
def test_k1_counters_on_a_source_load(monkeypatch):
    """Each K1 library loaded adds 1 to ``k1.attrs`` and its registers
    and local bytes a thread to ``k1.regs`` and ``k1.local_bytes``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (run on the GPU)")
    from repro_torch.kernels.stencil2d import kernel as k1
    kplan = compile_program(ALL_PROGRAMS["hydro2d"](), backend="interp_torch",
                            device="cpu").kernel_plan
    # no library loaded yet in this process, whatever ran before
    monkeypatch.setattr(k1, "_CALLS", {})
    before = {k: obs.counter(k) for k in ("k1.attrs", "k1.regs",
                                          "k1.local_bytes")}
    lib = k1.build_library(kplan.calls[0], torch.float16)
    a = k1.attrs(lib)
    assert 0 < a["regs"] <= 255 and a["local_bytes"] >= 0
    assert obs.counter("k1.attrs") - before["k1.attrs"] == 1
    assert obs.counter("k1.regs") - before["k1.regs"] == a["regs"]
    assert obs.counter("k1.local_bytes") - before["k1.local_bytes"] == \
        a["local_bytes"]
    # a second request of the same source loads nothing
    k1.build_library(kplan.calls[0], torch.float16)
    assert obs.counter("k1.attrs") - before["k1.attrs"] == 1
    # and the card runs the program through K1 as the plain version does
    a32 = {k: v.cuda() for k, v in state(64, 300, 9, torch.float32).items()}
    got = compile_program(ALL_PROGRAMS["hydro2d"](), backend="cuda",
                          device="cuda").fn(**a32)
    x = {k: v.double() for k, v in a32.items()}
    want, skip = ref.forward(x), ref.undecided(x)
    for k in want:
        assert rel_l2(got[k], want[k], skip[k]) <= FLOAT32_RTOL, k
    assert np.isfinite(got["enew"].cpu().numpy()).all()
