"""``repro_torch.core.compile_program``: the port's entry point against
the reference's on the paper's workloads, its device rule (the card
unless asked for the CPU, never a silent fallback) and its refusals."""
import dataclasses

import numpy as np
import pytest
import torch

from _interp_utils import arrays_for
from repro.core import compile_program as ref_compile
from repro.core.programs import ALL_PROGRAMS as REF_PROGRAMS
from repro_torch.core import (ALL_PROGRAMS, PlanUnsupported,
                              clear_compile_cache, compile_program,
                              execute_plan)
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
    gen = compile_program(ALL_PROGRAMS["laplace5"](), backend="interp_torch",
                          device="cpu")
    with pytest.raises(PlanUnsupported, match="float32"):
        execute_plan(gen.kernel_plan, interpreter="cuda",
                     dtype=torch.float64, device="cpu")
    with pytest.raises(PlanUnsupported, match="float32"):
        k1.build_call(gen.kernel_plan.calls[0], (7, 20), torch.float16)


@pytest.mark.parametrize("backend", ["auto", "jax"])
def test_emitter_backends_are_not_ported_yet(backend):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        compile_program(ALL_PROGRAMS["laplace5"](), backend=backend,
                        device="cpu")


def test_unknown_backend_lists_registered_interpreters():
    with pytest.raises(ValueError, match="interp_torch"):
        compile_program(ALL_PROGRAMS["laplace5"](), backend="pallas",
                        device="cpu")


def test_unknown_build_option_raises():
    with pytest.raises(TypeError, match="chunk"):
        compile_program(ALL_PROGRAMS["laplace5"](), backend="interp_torch",
                        device="cpu", chunk=4)


@pytest.mark.parametrize("interp", ["cuda", "interp_torch"])
def test_layout_constructs_are_refused(interp):
    """A plan carrying a LayoutApply construct (here a padded window)
    is refused with the typed PlanUnsupported before anything builds."""
    kplan = compile_program(ALL_PROGRAMS["laplace5"](),
                            backend="interp_torch", device="cpu").kernel_plan
    call = kplan.calls[0]
    padded = dataclasses.replace(call, inputs=tuple(
        dataclasses.replace(i, align_pad=1) for i in call.inputs))
    bad = dataclasses.replace(kplan, calls=(padded,))
    with pytest.raises(PlanUnsupported, match="align_pad"):
        execute_plan(bad, interpreter=interp, device="cpu")
