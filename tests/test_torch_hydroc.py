"""HydroC's time loop on the port (``repro_torch.core.hydroc``) on the CPU:
the driver marching Sedov's point blast through ``interp_torch`` and the
emulated K1, against the benchmark's plain float64 reference
(``portbench/reference/hydroc.py``, which imports nothing of the port);
the fused x-y step against HydroC's split x sweep, refill, y sweep; the
Courant reduction and its region; the walls' conservation; the spans and
counters; the scalar input's plan; and the constant-``dt`` ``hydro2d``
left as it was."""
import hashlib
import json

import pytest
import torch

from _emulate import emulated
from portbench.harness import rel_l2
from portbench.reference import hydroc as ref
from repro_torch import obs
from repro_torch.core import (ALL_PROGRAMS, PORT_ONLY, KernelPlan, Program,
                              axiom, build_unfused, compile_program, goal,
                              kernel)
from repro_torch.core.hydro2d import hydroc_program
from repro_torch.core.hydroc import (COURANT_FACTOR, HydroC, _courant_max,
                                     courant_program, reflect)
from repro_torch.kernels.stencil2d.emit import emit_source

#: float32 against the float64 reference over a pair of steps of the
#: blast, in relative L2 outside the tied fan samplings: 5.6e-8 to 2.6e-6
#: at 64 x 64 and 48 x 80 over six pairs (each output point comes out of
#: about 1,400 float32 operations a step, two steps a pair; at these
#: grids the blast is a few cells wide and the tie mask leaves little of
#: its momenta, so the norm under the error is small); the limit leaves
#: nearly four times the largest.
FLOAT32_RTOL = 1e-5
#: The hydro2d sources (single, batched, seated, in float32, bfloat16 and
#: float16) and the plan of both orders, hashed before the step learned a
#: scalar ``dtdx``.
HYDRO2D_PINS = {"xy": "ba6b97734cf2c41f", "yx": "776d147ce97b262c"}


def sedov(nj, ni, dtype=torch.float64):
    """Sedov's start as the benchmark draws it: density 1, at rest,
    energy 1e-5 and ``1 / dx**2`` in the corner's first interior cell."""
    e = torch.full((nj, ni), 1e-5, dtype=dtype)
    e[2, 2] = float(ni - 4) ** 2
    return {"rho": torch.ones(nj, ni, dtype=dtype),
            "rhou": torch.zeros(nj, ni, dtype=dtype),
            "rhov": torch.zeros(nj, ni, dtype=dtype), "E": e}


def physical(nj, ni, seed, dtype=torch.float64):
    """A seeded state with its frame filled: ``rho = x*x + 1``, momenta
    standard normal, ``E = 20 + x*x``."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((4, nj, ni), generator=g, dtype=torch.float64)
    s = {"rho": x[0] ** 2 + 1, "rhou": x[1].clone(), "rhov": x[2].clone(),
         "E": x[3] ** 2 + 20}
    return {k: v.to(dtype) for k, v in reflect(s).items()}


def march(hc, pairs):
    """``pairs`` pairs of ``hc``'s steps: each pair's (start as float64,
    its step, its dtdx, the state after it as float64), frames filled."""
    out = []
    for _ in range(pairs):
        start = {k: v.double().clone() for k, v in hc.filled().items()}
        nstep = hc.nstep
        hc.step()
        dtdx = hc.dtdx
        hc.step()
        end = {k: v.double() for k, v in hc.filled().items()}
        out.append((start, nstep, dtdx, end))
    return out


@pytest.fixture(scope="module")
def emulator():
    with emulated() as name:
        yield name


def test_registered_as_the_ports_own():
    assert set(PORT_ONLY) == {"hydro2d", "courant", "hydroc"}
    assert ALL_PROGRAMS["courant"] is courant_program
    assert ALL_PROGRAMS["hydroc"] is hydroc_program


@pytest.mark.parametrize("shape", [(64, 64), (48, 80)])
def test_float64_march_matches_the_reference(shape):
    hc = HydroC(backend="interp_torch", device="cpu", dtype=torch.float64)
    hc.start(sedov(*shape))
    for start, nstep, dtdx, end in march(hc, 6):
        want, want_dt = ref.pair(start, nstep)
        torch.testing.assert_close(dtdx, want_dt, rtol=1e-12, atol=0)
        for k in ref.STATE:
            torch.testing.assert_close(end[k], want[k], rtol=1e-12,
                                       atol=1e-12, msg=k)
    assert hc.nstep == 12


@pytest.mark.parametrize("shape", [(64, 64), (48, 80)])
def test_float32_march_within_its_rounding(shape):
    hc = HydroC(backend="interp_torch", device="cpu", dtype=torch.float32)
    hc.start(sedov(*shape, torch.float32))
    for start, nstep, dtdx, end in march(hc, 6):
        assert dtdx.dtype == torch.float32
        want, want_dt = ref.pair(start, nstep)
        skip = ref.undecided({**start, "nstep": torch.tensor(nstep)})
        assert float(abs(dtdx.double() - want_dt) / want_dt) <= FLOAT32_RTOL
        for o, k in zip(ref.OUTPUTS, ref.STATE):
            assert rel_l2(end[k], want[k], skip[o]) <= FLOAT32_RTOL, k


def test_emulated_k1_marches_as_the_reference(emulator):
    """Three K1 launch kinds a pair: the Courant reduction (folded on
    the device), x-y and y-x."""
    hc = HydroC(backend=emulator, device="cpu")
    hc.start(sedov(24, 40, torch.float32))
    folded = obs.counter("k1.folded")
    launches = obs.counter("k1.launch")
    for start, nstep, dtdx, end in march(hc, 2):
        want, want_dt = ref.pair(start, nstep)
        skip = ref.undecided({**start, "nstep": torch.tensor(nstep)})
        assert float(abs(dtdx.double() - want_dt) / want_dt) <= FLOAT32_RTOL
        for o, k in zip(ref.OUTPUTS, ref.STATE):
            assert rel_l2(end[k], want[k], skip[o]) <= FLOAT32_RTOL, k
    assert obs.counter("k1.folded") - folded == 2
    assert obs.counter("k1.launch") - launches == 6


def test_fused_xy_step_is_the_split_sweeps_with_a_refill_between():
    """On a state whose frame mirrors its interior, the fused x-y step
    equals HydroC's sequence: the x sweep, the frame refilled, the y
    sweep on the refilled state."""
    s = physical(20, 27, seed=11)
    dtdx = torch.tensor(0.03, dtype=torch.float64)
    fused = compile_program(hydroc_program(), backend="interp_torch",
                            device="cpu", dtype=torch.float64).fn(
                                **s, dtdx=dtdx)
    # the x sweep along each row, the frame refilled, the y sweep
    mid = {k: v.clone() for k, v in s.items()}
    xs = ref._sweep(*(s[k] for k in ref.STATE), dtdx)
    for k, v in zip(ref.STATE, xs):
        mid[k][:, 2:-2] = v
    reflect(mid)
    ys = ref._sweep(*(mid[k].T for k in ("rho", "rhov", "rhou", "E")), dtdx)
    for o, v in zip(("rnew", "vnew", "unew", "enew"), ys):
        torch.testing.assert_close(fused[o][2:-2, 2:-2], v.T[:, 2:-2],
                                   rtol=1e-12, atol=1e-12, msg=o)


def test_courant_gives_the_references_dtdx_halved_at_step_zero():
    s = physical(18, 23, seed=5)
    got = compile_program(courant_program(), backend="interp_torch",
                          device="cpu", dtype=torch.float64).fn(**s)["dtdx"]
    torch.testing.assert_close(got, ref.dtdx_of(s, 2), rtol=1e-14, atol=0)
    torch.testing.assert_close(ref.dtdx_of(s, 0), ref.dtdx_of(s, 2) * 0.5)
    hc = HydroC(backend="interp_torch", device="cpu", dtype=torch.float64)
    hc.start({k: v.clone() for k, v in s.items()})
    hc.step()
    torch.testing.assert_close(hc.dtdx, got * 0.5, rtol=0, atol=0)
    first = hc.dtdx
    hc.step()
    assert hc.dtdx is first                # the odd step reuses it
    third = {k: v.clone() for k, v in hc.filled().items()}
    hc.step()
    torch.testing.assert_close(
        hc.dtdx, COURANT_FACTOR / ref.courant(third), rtol=1e-14, atol=0)


def test_courant_folds_the_interior_only():
    """A ghost cell faster than every interior cell changes nothing."""
    s = physical(16, 21, seed=3)
    fn = compile_program(courant_program(), backend="interp_torch",
                         device="cpu", dtype=torch.float64).fn
    before = fn(**s)["dtdx"]
    for i, j in ((0, 5), (1, 0), (15, 20), (8, 19)):
        s["rhou"][i, j] = 1e6
    assert torch.equal(fn(**s)["dtdx"], before)
    s["rhou"][2, 2] = 1e6
    assert float(fn(**s)["dtdx"]) < float(before) / 1e3
    for other in (build_unfused(courant_program()).fn,
                  compile_program(courant_program(), backend="torch",
                                  device="cpu", dtype=torch.float64).fn):
        torch.testing.assert_close(other(**s)["dtdx"], fn(**s)["dtdx"],
                                   rtol=1e-14, atol=0)


def test_a_region_belongs_to_a_reduction_over_its_dims():
    with pytest.raises(ValueError, match="only a reduction"):
        kernel("k", [("a", "u[j?][i?]")], [("o", "v(u[j?][i?])")],
               within={"i": ("Ni", 1, -1)})
    row_sums = Program(
        rules=[kernel("rsum", [("x", "u[j][i]")], [("acc", "rsum(u[j])")],
                      fn=_courant_max, kind="reduce",
                      within={"j": ("Nj", 1, -1)})],
        axioms=[axiom("u[j?][i?]", j="Nj", i="Ni")],
        goals=[goal("rsum(u[j])", store_as="rsum", j=("Nj", 0, 0))],
        loop_order=("j", "i"), name="rsum_within_j")
    with pytest.raises(ValueError, match="does not reduce"):
        compile_program(row_sums, backend="interp_torch", device="cpu",
                        use_cache=False)


def test_walls_conserve_mass_and_energy():
    hc = HydroC(backend="interp_torch", device="cpu", dtype=torch.float64)
    hc.start(sedov(40, 40))
    first = ref.totals(hc.filled())
    pairs = march(hc, 6)
    last = ref.totals(pairs[-1][3])
    for k in first:
        assert float(abs(last[k] - first[k]) / first[k]) <= 1e-12, k
    # the blast runs along both walls, which mirror it
    end = pairs[-1][3]
    assert float(end["E"][2, 6]) > 1e-4 and float(end["E"][6, 2]) > 1e-4
    assert torch.equal(end["rhou"][:, 1], -end["rhou"][:, 2])
    assert torch.equal(end["rhov"][1], -end["rhov"][2])
    assert torch.equal(end["E"][:, 0], end["E"][:, 3])


def test_spans_and_counters_of_a_march():
    hc = HydroC(backend="interp_torch", device="cpu")
    hc.start(sedov(20, 24, torch.float32))
    before = {k: obs.counter(k) for k in ("hydroc.steps", "hydroc.courant")}
    obs.disable()
    obs.drain()
    obs.enable()
    try:
        for _ in range(6):
            hc.step()
        spans = obs.pair(obs.drain())
    finally:
        obs.disable()
        obs.drain()
    assert obs.counter("hydroc.steps") - before["hydroc.steps"] == 6
    assert obs.counter("hydroc.courant") - before["hydroc.courant"] == 3
    names = [spans.label(i) for i in range(len(spans))]
    steps = [i for i, n in enumerate(names) if n == "hydroc.step"]
    assert len(steps) == 6
    inside = {}
    for i, n in enumerate(names):
        p = int(spans.parent[i])
        while p >= 0 and names[p] != "hydroc.step":
            p = int(spans.parent[p])
        if p >= 0:
            inside.setdefault(n, 0)
            inside[n] += 1
    assert inside["hydroc.boundary"] == 6
    assert inside["hydroc.courant"] == 3
    assert inside["plan.run"] == 9          # a sweep a step, 3 reductions


def test_scalar_input_plans_and_validates():
    kplan = compile_program(hydroc_program(), backend="interp_torch",
                            device="cpu").kernel_plan
    call, = kplan.calls
    scalars = [i for i in call.inputs if i.scalar]
    assert [i.name for i in scalars] == ["dtdx"]
    assert {a.array for a in kplan.axioms} == {"rho", "rhou", "rhov", "E",
                                              "dtdx"}
    kplan.validate()
    again = KernelPlan.from_dict(json.loads(json.dumps(kplan.to_dict())))
    assert again.to_dict() == kplan.to_dict()
    src = emit_source(call, torch.float32, seated=True)
    assert "#define HFAV_NP 11" in src
    s = physical(13, 17, seed=2)
    dtdx = torch.tensor(0.04, dtype=torch.float64)
    got = compile_program(hydroc_program(), backend="interp_torch",
                          device="cpu", dtype=torch.float64).fn(**s,
                                                                dtdx=dtdx)
    want = build_unfused(hydroc_program()).fn(**s, dtdx=dtdx)
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=1e-12, atol=1e-12)


def test_scalar_input_at_hydro2ds_constant_is_hydro2d():
    s = physical(15, 19, seed=8)
    const = compile_program(ALL_PROGRAMS["hydro2d"](), backend="interp_torch",
                            device="cpu", dtype=torch.float64).fn(**s)
    scalar = compile_program(hydroc_program(), backend="interp_torch",
                             device="cpu", dtype=torch.float64).fn(
        **s, dtdx=torch.tensor(0.8 / 12.0, dtype=torch.float64))
    for k in const:
        assert torch.equal(const[k], scalar[k]), k


@pytest.mark.parametrize("order", ["xy", "yx"])
def test_constant_hydro2d_sources_and_plan_are_unchanged(order):
    from repro_torch.core.hydro2d import hydro2d_program
    prog = ALL_PROGRAMS["hydro2d"]() if order == "xy" \
        else hydro2d_program(order="yx")
    kplan = compile_program(prog, backend="interp_torch", device="cpu",
                            use_cache=False).kernel_plan
    h = hashlib.sha256()
    for dt in (torch.float32, torch.bfloat16, torch.float16):
        for batched in (False, True):
            for call in kplan.calls:
                if call.has_grid:
                    h.update(emit_source(call, dt, batched=batched).encode())
                    h.update(emit_source(call, dt, batched=batched,
                                         seated=True).encode())
    h.update(json.dumps(kplan.to_dict(), sort_keys=True,
                        default=str).encode())
    assert h.hexdigest()[:16] == HYDRO2D_PINS[order]


@pytest.mark.cuda
def test_cuda_march_reads_nothing_back_inside_a_step():
    """On the card, through K1 (``backend="auto"``): steps under
    ``torch.cuda``'s synchronisation check (any host read raises), then
    each pair against the reference, and three K1 launch kinds a pair,
    one folding on the device."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (run on the GPU)")
    hc = HydroC(device="cuda")
    hc.start({k: v.cuda() for k, v in sedov(256, 384, torch.float32).items()})
    march(hc, 2)                            # builds the three kernels
    torch.cuda.synchronize()
    launches, folded = obs.counter("k1.launch"), obs.counter("k1.folded")
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(4):
            hc.step()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert obs.counter("k1.launch") - launches == 6
    assert obs.counter("k1.folded") - folded == 2
    for start, nstep, dtdx, end in march(hc, 3):
        want, want_dt = ref.pair(start, nstep)
        skip = ref.undecided({**start, "nstep": torch.tensor(nstep)})
        assert float(abs(dtdx.double() - want_dt) / want_dt) <= FLOAT32_RTOL
        for o, k in zip(ref.OUTPUTS, ref.STATE):
            assert rel_l2(end[k], want[k], skip[o]) <= FLOAT32_RTOL, k
