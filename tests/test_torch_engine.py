"""``repro_torch.core.compile_program``: the port's entry point against
the reference's on the paper's workloads, its device rule (the card
unless asked for the CPU, never a silent fallback) and its refusals."""
import dataclasses

import numpy as np
import pytest
import torch

from _emulate import _arrays, emulated
from _interp_utils import arrays_for
from repro.core import compile_program as ref_compile
from repro.core.programs import ALL_PROGRAMS as REF_PROGRAMS
from repro_torch import obs
from repro_torch.core import (ALL_PROGRAMS, PlanUnsupported, build_unfused,
                              clear_compile_cache, compile_program,
                              execute_plan, get_interpreter)
from repro_torch.kernels.stencil2d import kernel as k1
from repro_torch.kernels.stencil2d import run_fused_stencil


@pytest.mark.parametrize("name", ["normalization", "cosmo", "hydro1d"])
def test_matches_reference_compile_program(name):
    ref = ref_compile(REF_PROGRAMS[name](), backend="interp_jax")
    arrs = {k: np.array(v) for k, v in
            arrays_for(ref.kernel_plan, np.random.default_rng(3)).items()}
    gen = compile_program(ALL_PROGRAMS[name](), backend="interp_torch",
                          device="cpu")
    assert gen.interpreter == "interp_torch"
    assert gen.device == torch.device("cpu")
    assert len(gen.kernel_plan.calls) == len(ref.kernel_plan.calls)
    got, want = gen.fn(**arrs), ref.fn(**arrs)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=2e-4, rtol=1e-3, err_msg=k)


def test_compile_is_memoized():
    prog = ALL_PROGRAMS["laplace5"]()
    a = compile_program(prog, backend="interp_torch", device="cpu")
    assert compile_program(ALL_PROGRAMS["laplace5"](),
                           backend="interp_torch", device="cpu") is a
    clear_compile_cache()
    assert compile_program(prog, backend="interp_torch", device="cpu") is not a


def test_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        compile_program(ALL_PROGRAMS["laplace5"]())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_fused_stencil(ALL_PROGRAMS["laplace5"](),
                          {"cell": np.zeros((5, 6), np.float32)})


def test_cuda_interpreter_refuses_cpu_tensors():
    """Given CPU tensors the CUDA kernel raises; it never substitutes
    its plain version."""
    gen = compile_program(ALL_PROGRAMS["laplace5"](), backend="cuda",
                          device="cpu")
    before = k1.launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        gen.fn(cell=np.zeros((7, 20), np.float32))
    call = gen.kernel_plan.calls[0]
    fn, _ = k1.build_call(call, (7, 20), torch.float32)
    with pytest.raises(ValueError, match="CUDA tensors"):
        fn(torch.zeros((7, 20)))
    assert k1.launches == before


def test_cuda_interpreter_is_float32_only():
    """(Named before the kernel took 2-byte types.)  The CUDA interpreter
    takes float32, bf16 and float16, as the reference's kernel takes any
    float dtype, and refuses float64, naming the types it builds for."""
    gen = compile_program(ALL_PROGRAMS["laplace5"](), backend="interp_torch",
                          device="cpu")
    with pytest.raises(PlanUnsupported,
                       match=r"\[.torch.bfloat16., .torch.float16., "
                             r".torch.float32.\], not torch.float64"):
        execute_plan(gen.kernel_plan, interpreter="cuda",
                     dtype=torch.float64, device="cpu")
    with pytest.raises(PlanUnsupported, match="float64"):
        k1.build_call(gen.kernel_plan.calls[0], (7, 20), torch.float64)
    fn, _ = k1.build_call(gen.kernel_plan.calls[0], (7, 20), torch.float16)
    with pytest.raises(ValueError, match="CUDA tensors"):  # never a fallback
        fn(torch.zeros((7, 20), dtype=torch.float16))


@pytest.mark.parametrize("backend", ["auto", "jax"])
def test_emitter_backends_are_not_ported_yet(backend):
    """The JAX package's emitter backends: ``"auto"`` compiles (and on
    the CPU runs the plain stencil interpreter), ``"jax"`` raises a
    ``ValueError`` naming the port's emitter, ``"torch"``."""
    prog = ALL_PROGRAMS["laplace5"]()
    if backend == "jax":
        with pytest.raises(ValueError, match="'torch'"):
            compile_program(prog, backend=backend, device="cpu")
        return
    gen = compile_program(prog, backend=backend, device="cpu")
    assert gen.interpreter == "interp_torch"
    u = np.random.default_rng(1).standard_normal((7, 20)).astype(np.float32)
    want = build_unfused(prog).fn(cell=u)["lap"]
    np.testing.assert_allclose(gen.fn(cell=u)["lap"].numpy(),
                               np.asarray(want), atol=2e-4, rtol=1e-3)


def test_unknown_backend_lists_registered_interpreters():
    with pytest.raises(ValueError, match="interp_torch"):
        compile_program(ALL_PROGRAMS["laplace5"](), backend="pallas",
                        device="cpu")


def test_unknown_build_option_raises():
    with pytest.raises(TypeError, match="chunk"):
        compile_program(ALL_PROGRAMS["laplace5"](), backend="interp_torch",
                        device="cpu", chunk=4)


@pytest.mark.parametrize("interp", ["cuda", "interp_torch", "emulated"])
def test_layout_constructs_are_refused(interp):
    """A plan carrying a LayoutApply construct (here a padded window):
    the CUDA kernel refuses it with the typed PlanUnsupported before
    anything builds, as the reference's Pallas kernel does; the
    layout-aware ``interp_torch`` executes it, bit-identical to the
    unpadded plan.  The CUDA kernel's host emulation
    (``tests/_emulate.py``) is the ``"cuda"`` spec with its driver's
    device facts swapped: it declares the card's seats, dtypes, flags and
    capabilities, refuses the plan as the card does, and stores a float32
    cosmo run's one output at its seat (``k1.seated`` 1,
    ``plan.reseated`` 0)."""
    kplan = compile_program(ALL_PROGRAMS["laplace5"](),
                            backend="interp_torch", device="cpu").kernel_plan
    call = kplan.calls[0]
    padded = dataclasses.replace(call, inputs=tuple(
        dataclasses.replace(i, align_pad=1) for i in call.inputs))
    bad = dataclasses.replace(kplan, calls=(padded,))
    if interp == "cuda":
        with pytest.raises(PlanUnsupported, match="align_pad"):
            execute_plan(bad, interpreter=interp, device="cpu")
        return
    if interp == "emulated":
        cuda = get_interpreter("cuda")
        with emulated() as name:
            emu = get_interpreter(name)
            assert (emu.seats, emu.dtypes, emu.flags, emu.capabilities) \
                == (cuda.seats, cuda.dtypes, cuda.flags, cuda.capabilities)
            with pytest.raises(PlanUnsupported, match="align_pad"):
                execute_plan(bad, interpreter=name, device="cpu")
            cosmo = compile_program(ALL_PROGRAMS["cosmo"](),
                                    backend="interp_torch",
                                    device="cpu").kernel_plan
            counters = ("k1.seated", "plan.reseated")
            before = [obs.counter(c) for c in counters]
            execute_plan(cosmo, interpreter=name, device="cpu")(
                **_arrays(cosmo, np.random.default_rng(4)))
            assert [obs.counter(c) - b
                    for c, b in zip(counters, before)] == [1, 0]
        return
    u = np.random.default_rng(2).standard_normal((7, 20)).astype(np.float32)
    got = execute_plan(bad, interpreter=interp, device="cpu")(cell=u)
    want = execute_plan(kplan, interpreter=interp, device="cpu")(cell=u)
    assert torch.equal(got["lap"], want["lap"])


# ---------------------------------------------------------------------------
# backend="auto": routing, refusals, the size consult
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("split_win", [False, True])
@pytest.mark.parametrize("name", sorted(REF_PROGRAMS))
def test_auto_routing_matches_reference(name, split_win):
    """``"auto"`` offers a program to the stencil interpreter exactly
    when the reference's ``pallas_auto_viable`` does, with and without
    the program registered as a split win; the rest take ``"torch"``."""
    import repro.core.engine as ref_engine
    import repro_torch.core.engine as engine
    try:
        if split_win:
            ref_engine.register_pallas_split_win(name)
            engine.register_pallas_split_win(name)
        want = ref_engine.pallas_auto_viable(
            ref_engine._build_plan(REF_PROGRAMS[name]())[1])
        got = engine.pallas_auto_viable(
            engine._build_plan(ALL_PROGRAMS[name]())[1])
        assert got == want
        gen = compile_program(ALL_PROGRAMS[name](), device="cpu")
        if want:
            assert gen.interpreter == "interp_torch"
        else:
            assert gen.backend == "torch" and "def hfav_" in gen.source
    finally:
        ref_engine.PALLAS_SPLIT_WINS.discard(name)
        engine.PALLAS_SPLIT_WINS.discard(name)
        clear_compile_cache()


def test_register_split_win_rejects_default_name_and_reroutes():
    import repro_torch.core.engine as engine
    with pytest.raises(ValueError, match="default program name"):
        engine.register_pallas_split_win("program")
    prog = ALL_PROGRAMS["normalization"]()
    assert compile_program(prog, device="cpu").backend == "torch"
    try:
        engine.register_pallas_split_win("normalization")
        gen = compile_program(prog, device="cpu")
        assert gen.interpreter == "interp_torch"
    finally:
        engine.PALLAS_SPLIT_WINS.discard("normalization")
        clear_compile_cache()


def test_auto_raises_when_the_stencil_interpreter_fails_to_build(monkeypatch):
    """A failed build is not a refusal: ``"auto"`` raises it and never
    routes the program to ``"torch"``."""
    import repro_torch.core.engine as engine
    from repro_torch.core import (InterpreterSpec, register_interpreter,
                                  unregister_interpreter)

    def broken_build(call, sizes, dtype, *, device=None):
        raise RuntimeError("nvcc failed building the stencil kernel")

    register_interpreter(InterpreterSpec(
        name="broken_stencil", build_call=broken_build,
        capabilities=get_interpreter("interp_torch").capabilities,
        dtypes=frozenset({torch.float32})))
    monkeypatch.setattr(engine, "auto_interpreter",
                        lambda device: "broken_stencil")
    try:
        gen = compile_program(ALL_PROGRAMS["laplace5"](), device="cpu",
                              use_cache=False)
        assert gen.interpreter == "broken_stencil"
        with pytest.raises(RuntimeError, match="nvcc failed"):
            gen.fn(cell=np.zeros((7, 20), np.float32))

        def boom(*a, **k):
            raise RuntimeError("CUDA error: launch failure")

        monkeypatch.setattr(engine, "execute_plan", boom)
        with pytest.raises(RuntimeError, match="launch failure"):
            compile_program(ALL_PROGRAMS["laplace5"](), device="cpu",
                            use_cache=False)
    finally:
        unregister_interpreter("broken_stencil")


def test_auto_falls_back_on_the_typed_capability_refusal(monkeypatch):
    """The CUDA kernel builds float32 only: a float64 ``"auto"``
    compilation offered to it is refused with PlanUnsupported before
    anything builds, and takes the emitter."""
    import repro_torch.core.engine as engine
    monkeypatch.setattr(engine, "auto_interpreter", lambda device: "cuda")
    gen = compile_program(ALL_PROGRAMS["laplace5"](), device="cpu",
                          dtype=torch.float64, use_cache=False)
    assert gen.backend == "torch"
    gen = compile_program(ALL_PROGRAMS["laplace5"](), device="cpu",
                          use_cache=False)
    assert gen.interpreter == "cuda"


def test_auto_size_consult_uses_the_kernels_shared_memory(monkeypatch):
    """``smem_report`` reads the CUDA kernel's own per-block region; a
    region over shared memory (kept in global scratch) and a narrow row
    under the lane-occupancy floor still take the kernel on the card,
    while the plain version's consult routes the narrow row to the
    emitter, as the reference's does."""
    import repro_torch.core.engine as engine
    from repro_torch.core.engine import smem_report
    from repro_torch.kernels.stencil2d.emit import SMEM_LIMIT
    prog = ALL_PROGRAMS["laplace5"]
    narrow = {"Nj": 64, "Ni": 24}
    wide = {"Nj": 256, "Ni": 16384}
    gen = compile_program(prog(), device="cpu", dim_sizes=wide)
    assert gen.interpreter == "interp_torch"
    (nbytes,) = smem_report(gen.kernel_plan, wide).values()
    assert nbytes > SMEM_LIMIT
    (nbytes,) = smem_report(gen.kernel_plan, narrow).values()
    assert 0 < nbytes <= SMEM_LIMIT
    assert compile_program(prog(), device="cpu",
                           dim_sizes=narrow).backend == "torch"
    monkeypatch.setattr(engine, "auto_interpreter", lambda device: "cuda")
    clear_compile_cache()
    for sizes in (wide, narrow):
        assert compile_program(prog(), device="cpu",
                               dim_sizes=sizes).interpreter == "cuda"
    clear_compile_cache()


@pytest.mark.parametrize("name", sorted(ALL_PROGRAMS))
def test_auto_offers_every_plan_to_the_cuda_kernel(name, monkeypatch):
    """On the card ``"auto"`` offers every program, split schedules
    included, to the CUDA kernel; on the CPU a split schedule keeps the
    reference's rule (the emitter unless registered as a win)."""
    import repro_torch.core.engine as engine
    plan = engine._build_plan(ALL_PROGRAMS[name]())[1]
    assert engine.pallas_auto_viable(plan, "cuda")
    split = len(plan.schedule.nests) > 1
    assert engine.pallas_auto_viable(plan, "interp_torch") is not split
    monkeypatch.setattr(engine, "auto_interpreter", lambda device: "cuda")
    try:
        gen = compile_program(ALL_PROGRAMS[name](), device="cpu",
                              use_cache=False)
        assert gen.interpreter == "cuda"
    finally:
        clear_compile_cache()


def test_auto_falls_back_on_plancheck_errors(monkeypatch):
    import repro_torch.core.engine as engine
    from repro_torch.core import Diagnostic

    def failing(kplan, **kw):
        return [Diagnostic("PC001", "error", "n0", "x", "hazard")]

    monkeypatch.setattr(engine, "check_plan", failing)
    prog = ALL_PROGRAMS["laplace5"]()
    assert compile_program(prog, device="cpu", check_plans="error",
                           use_cache=False).backend == "torch"
    from repro_torch.core import PlanCheckError
    with pytest.raises(PlanCheckError):
        compile_program(prog, backend="interp_torch", device="cpu",
                        check_plans="error", use_cache=False)


def test_auto_build_options_reach_only_the_kernel():
    """``chunk``/``plane_chunk`` are the CUDA kernel's: ``"auto"`` on the
    CPU drops them for the plain interpreter; an option no backend
    takes raises."""
    gen = compile_program(ALL_PROGRAMS["laplace5"](), device="cpu", chunk=4)
    assert gen.interpreter == "interp_torch"
    with pytest.raises(TypeError, match="bogus"):
        compile_program(ALL_PROGRAMS["laplace5"](), device="cpu", bogus=1)
    with pytest.raises(TypeError, match="chunk"):
        compile_program(ALL_PROGRAMS["laplace5"](), backend="torch",
                        device="cpu", chunk=4)


# ---------------------------------------------------------------------------
# The plan-level LRU cache, explain, vec_report, compile_batched
# ---------------------------------------------------------------------------

def test_plan_cache_lru_cap_and_eviction():
    from repro_torch.core import (plan_cache_cap, plan_cache_size,
                                  set_plan_cache_cap)
    clear_compile_cache()
    prev = set_plan_cache_cap(2)
    try:
        assert plan_cache_cap() == 2
        names = ["laplace5", "heat3d", "row_sum"]
        gens = [compile_program(ALL_PROGRAMS[n](), backend="interp_torch",
                                device="cpu") for n in names]
        assert plan_cache_size() == 2
        # the oldest entry was evicted: with the signature-level cache
        # dropped, laplace5 rebuilds while row_sum's executor survives
        import repro_torch.core.engine as engine
        engine._CACHE.clear()
        again = compile_program(ALL_PROGRAMS["laplace5"](),
                                backend="interp_torch", device="cpu")
        assert again is not gens[0]
        assert compile_program(ALL_PROGRAMS["row_sum"](),
                               backend="interp_torch",
                               device="cpu") is gens[2]
        set_plan_cache_cap(1)
        assert plan_cache_size() == 1
        with pytest.raises(ValueError, match=">= 1"):
            set_plan_cache_cap(0)
    finally:
        set_plan_cache_cap(prev)
        clear_compile_cache()


def test_equal_plans_share_one_executor_per_interpreter():
    """Two compilations under different signature-level keys that lower
    to one plan share the plan-level executor; another interpreter over
    the same plan gets its own."""
    prog = ALL_PROGRAMS["laplace5"]
    a = compile_program(prog(), backend="interp_torch", device="cpu")
    b = compile_program(prog(), backend="interp_torch", device="cpu",
                        dim_sizes={"Nj": 7, "Ni": 20})
    c = compile_program(prog(), backend="cuda", device="cpu")
    assert b is a
    assert c is not a and c.interpreter == "cuda"
    assert c.kernel_plan == a.kernel_plan


def test_explain_sections():
    from repro_torch.core import explain
    text = explain(ALL_PROGRAMS["cosmo"](), device="cpu", verbose=True,
                   dim_sizes={"Nk": 4, "Nj": 64, "Ni": 512},
                   apply_layout="auto")
    for section in ("program: cosmo", "auto backend: interp_torch",
                    "--- fused schedule ---", "--- storage plan ---",
                    "--- kernel plan ---", "--- shared memory estimate ---",
                    "--- vectorization ---", "--- layout apply ---",
                    "apply mode: auto", "applied  shift_reuse"):
        assert section in text, section
    assert "B a block, in shared memory (shared memory holds 232448 B)" in text
    split = explain(ALL_PROGRAMS["normalization"](), device="cpu",
                    verbose=True)
    assert "auto backend: torch" in split
    assert "fused-source emitter" in split


def test_vec_report_is_attached_to_plan_backed_artifacts():
    gen = compile_program(ALL_PROGRAMS["laplace5"](), backend="interp_torch",
                          device="cpu", vec_report=True,
                          dim_sizes={"Nj": 64, "Ni": 256})
    assert gen.vec_report is not None
    assert gen.vec_report.lane_occupancy is not None
    emitted = compile_program(ALL_PROGRAMS["normalization"](),
                              backend="torch", device="cpu", vec_report=True)
    assert not hasattr(emitted, "vec_report")


@pytest.mark.parametrize("backend", ["torch", "interp_torch", "auto"])
def test_compile_batched_is_per_example_bit_for_bit(backend):
    from repro_torch.core import compile_batched
    prog = ALL_PROGRAMS["hydro1d"]()
    rng = np.random.default_rng(5)
    rho = (rng.standard_normal((3, 6, 21)) ** 2 + 1).astype(np.float32)
    mom = rng.standard_normal((3, 6, 21)).astype(np.float32)
    bgen = compile_batched(prog, backend, device="cpu")
    out = bgen.fn({"rho": rho, "mom": mom})
    single = compile_program(prog, backend, device="cpu")
    for b in range(3):
        want = single.fn(rho=rho[b], mom=mom[b])
        for k in want:
            assert out[k].shape[0] == 3
            assert torch.equal(out[k][b], want[k]), (k, b)
    with pytest.raises(ValueError, match="batch width"):
        bgen.fn({"rho": rho, "mom": mom[:2]})
