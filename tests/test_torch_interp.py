"""The plain PyTorch plan interpreter (``interp_torch``, the CUDA
kernel's plain version) against the reference on every program: the
JAX package's ``interp_jax`` and unfused evaluator, and the port's own
unfused evaluator, on the same seeded inputs."""
import numpy as np
import pytest
import torch

from _interp_utils import arrays_for
from repro.core import compile_program as ref_compile
from repro.core.programs import ALL_PROGRAMS as REF_PROGRAMS
from repro.core.unfused import build_unfused as ref_unfused
from repro_torch.core import ALL_PROGRAMS, build_unfused, compile_program
from repro_torch.core.interp_torch import build_call
from repro_torch.core.runtime import lane_reduce

ATOL, RTOL = 2e-4, 1e-3


def _close(got, want, tag):
    for k in want:
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(want[k]),
                                   atol=ATOL, rtol=RTOL, err_msg=f"{tag}:{k}")


@pytest.mark.parametrize("name", sorted(REF_PROGRAMS))
def test_interp_torch_matches_reference(name):
    ref = ref_compile(REF_PROGRAMS[name](), backend="interp_jax")
    arrs = {k: np.array(v) for k, v in
            arrays_for(ref.kernel_plan, np.random.default_rng(7)).items()}
    got = compile_program(ALL_PROGRAMS[name](), backend="interp_torch",
                          device="cpu").fn(**arrs)
    assert set(got) == {store for store, _ in ref.kernel_plan.goal_outputs}
    assert all(isinstance(v, torch.Tensor) and v.device.type == "cpu"
               for v in got.values())
    _close(got, ref.fn(**arrs), f"interp_jax/{name}")
    _close(got, ref_unfused(REF_PROGRAMS[name]()).fn(**arrs),
           f"unfused/{name}")
    _close(got, build_unfused(ALL_PROGRAMS[name]()).fn(**arrs),
           f"port-unfused/{name}")


def test_interp_torch_rejects_mismatched_sizes():
    gen = compile_program(ALL_PROGRAMS["cosmo"](), backend="interp_torch",
                          device="cpu")
    with pytest.raises(ValueError, match="n_outer"):
        build_call(gen.kernel_plan.calls[0], (5, 6), torch.float32)


@pytest.mark.parametrize("n", [1, 2, 5, 8])
def test_lane_reduce_folds_like_a_sum(n):
    rows = torch.arange(n * 3, dtype=torch.float32).reshape(n, 3)
    got = lane_reduce(lambda a, b: a + b, rows, 0.0)
    assert torch.equal(got, rows.sum(0))
