"""``interp_torch`` in bf16 against the reference's ``interp_jax`` in
bf16, and ``"auto"``'s route for bf16 on the CPU against the
reference's.

Both interpreters allocate their windows, accumulators and outputs in
the call's dtype, so the two compute the same bf16 function.  The
tolerance is the reference's bf16 one, ``atol = rtol = 2e-2``
(``tests/test_kernels.py``), with ``atol`` taken relative to the
output's largest magnitude: hydro1d's outputs reach a few thousand,
where one bf16 step is 16."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from _interp_utils import arrays_for
from repro.core import compile_program as ref_compile
from repro.core.programs import ALL_PROGRAMS as REF_PROGRAMS
from repro_torch.core import ALL_PROGRAMS, compile_program

BF16_TOL = 2e-2
PROGRAMS = ["normalization", "cosmo", "hydro1d", "laplace5"]


@pytest.mark.parametrize("name", PROGRAMS)
def test_interp_torch_bf16_matches_interp_jax(name):
    ref = ref_compile(REF_PROGRAMS[name](), backend="interp_jax",
                      dtype=jnp.bfloat16)
    arrs = {k: np.array(v) for k, v in
            arrays_for(ref.kernel_plan, np.random.default_rng(3)).items()}
    gen = compile_program(ALL_PROGRAMS[name](), backend="interp_torch",
                          dtype=torch.bfloat16, device="cpu")
    assert gen.interpreter == "interp_torch"
    got, want = gen.fn(**arrs), ref.fn(**arrs)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == torch.bfloat16, k
        w = np.asarray(want[k].astype(jnp.float32))
        g = got[k].float().numpy()
        assert np.isfinite(g).all(), k
        scale = max(float(np.abs(w).max()), 1.0)
        np.testing.assert_allclose(g, w, atol=BF16_TOL * scale,
                                   rtol=BF16_TOL, err_msg=k)


@pytest.mark.parametrize("name", PROGRAMS)
def test_auto_routes_bf16_as_the_reference(name):
    """On the CPU ``"auto"`` offers a bf16 plan to ``interp_torch`` as
    the reference offers it to its plan interpreter; a split program
    (normalization) goes to the source emitter in both packages, and
    in both dtypes."""
    ref = ref_compile(REF_PROGRAMS[name](), backend="auto",
                      dtype=jnp.bfloat16)
    for dt in (torch.bfloat16, torch.float32):
        gen = compile_program(ALL_PROGRAMS[name](), backend="auto",
                              dtype=dt, device="cpu")
        if hasattr(ref, "kernel_plan"):
            assert gen.interpreter == "interp_torch", (name, dt)
        else:
            assert not hasattr(gen, "interpreter"), (name, dt)
