"""``interp_torch`` in float16 against the reference's ``interp_jax`` in
float16, for every program, and ``"auto"``'s route for float16 on the
CPU against the reference's.

Both interpreters allocate their windows, accumulators and outputs in
the call's dtype, so the two compute the same float16 function, in
sums of another order.  float16 keeps 11 significant bits (bf16: 8), so
the tolerance is bf16's ``2e-2`` divided by 8, ``atol = rtol =
2.5e-3``, ``atol`` taken relative to the output's largest finite
magnitude.  float16's range ends at 65504: hydro1d's outputs pass it at
these inputs in both packages, so the non-finite values must fall on
the same elements, and the tolerance holds over the rest."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from _interp_utils import arrays_for
from repro.core import compile_program as ref_compile
from repro.core.programs import ALL_PROGRAMS as REF_PROGRAMS
from repro_torch.core import ALL_PROGRAMS, compile_program

FP16_TOL = 2.5e-3
#: The split programs (a host step between two nests), which ``"auto"``
#: sends to the source emitter in both packages.
SPLIT = ("normalization", "smooth_norm")


@pytest.mark.parametrize("name", sorted(REF_PROGRAMS))
def test_interp_torch_float16_matches_interp_jax(name):
    ref = ref_compile(REF_PROGRAMS[name](), backend="interp_jax",
                      dtype=jnp.float16)
    arrs = {k: np.array(v) for k, v in
            arrays_for(ref.kernel_plan, np.random.default_rng(3)).items()}
    gen = compile_program(ALL_PROGRAMS[name](), backend="interp_torch",
                          dtype=torch.float16, device="cpu")
    assert gen.interpreter == "interp_torch"
    got, want = gen.fn(**arrs), ref.fn(**arrs)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == torch.float16, k
        w = np.asarray(want[k].astype(jnp.float32))
        g = got[k].float().numpy()
        finite = np.isfinite(w)
        np.testing.assert_array_equal(np.isfinite(g), finite, err_msg=k)
        assert finite.any(), k
        scale = max(float(np.abs(w[finite]).max()), 1.0)
        np.testing.assert_allclose(g[finite], w[finite],
                                   atol=FP16_TOL * scale, rtol=FP16_TOL,
                                   err_msg=k)


def test_hydro1d_overflows_float16_in_both_packages():
    """The case the non-finite rule is for: float32 reaches a few
    thousand on hydro1d at these inputs, and the reference's float16
    passes 65504 on some elements, as the port's does."""
    ref = ref_compile(REF_PROGRAMS["hydro1d"](), backend="interp_jax",
                      dtype=jnp.float16)
    arrs = {k: np.array(v) for k, v in
            arrays_for(ref.kernel_plan, np.random.default_rng(3)).items()}
    want = ref.fn(**arrs)
    got = compile_program(ALL_PROGRAMS["hydro1d"](), backend="interp_torch",
                          dtype=torch.float16, device="cpu").fn(**arrs)
    bad_ref = sum(int((~np.isfinite(np.asarray(v.astype(jnp.float32)))).sum())
                  for v in want.values())
    bad = sum(int((~torch.isfinite(v.float())).sum()) for v in got.values())
    assert bad_ref > 0 and bad == bad_ref


@pytest.mark.parametrize("name", sorted(REF_PROGRAMS))
def test_auto_routes_float16_as_the_reference(name):
    """On the CPU ``"auto"`` offers a float16 plan to ``interp_torch`` as
    the reference offers it to its plan interpreter; the split programs
    go to the source emitter in both packages."""
    ref = ref_compile(REF_PROGRAMS[name](), backend="auto",
                      dtype=jnp.float16)
    gen = compile_program(ALL_PROGRAMS[name](), backend="auto",
                          dtype=torch.float16, device="cpu")
    if hasattr(ref, "kernel_plan"):
        assert gen.interpreter == "interp_torch", name
    else:
        assert not hasattr(gen, "interpreter"), name
    assert hasattr(ref, "kernel_plan") == (name not in SPLIT)
