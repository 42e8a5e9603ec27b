"""The port's SSD scan (K4's plain versions) against the JAX package.

The same seeded numpy inputs go through the reference's ``naive_ssd``,
``ssd_scan`` and ``ssd_pallas(interpret=True)`` and through the port's
``naive_ssd``, ``ssd_scan`` and ``ssd(impl="pallas")``, which on CPU
tensors runs the kernel's plain version with the kernel's chunk length.
The cases are those of ``tests/test_kernels.py::test_ssd``, at its
tolerance (float32, ``atol=5e-5, rtol=1e-3``), plus a sequence that is
not a multiple of the chunk, decays that underflow, and bf16 inputs
(``2e-2``: one bf16 rounding of the output in each package).  The
kernel itself is held against ``ssd_scan`` in
``tests/test_torch_ssd_kernel.py``.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd import naive_ssd as jax_naive_ssd
from repro.kernels.ssd import ssd_pallas as jax_ssd_pallas
from repro.kernels.ssd import ssd_scan as jax_ssd_scan
from repro_torch.kernels.ssd import kernel as k4
from repro_torch.kernels.ssd import naive_ssd, ssd, ssd_scan

TOL = dict(atol=5e-5, rtol=1e-3)
BF16_TOL = dict(atol=2e-2, rtol=2e-2)
# B, S, H, P, N, chunk (tests/test_kernels.py::test_ssd)
CASES = [(2, 128, 3, 32, 16, 32), (1, 64, 2, 16, 8, 64),
         (2, 96, 4, 64, 32, 32)]


def _inputs(B, S, H, P, N, seed=0, dt_shift=-1.0):
    """Seeded numpy inputs in the reference test's distributions; a
    larger ``dt_shift`` makes larger steps (faster decays)."""
    rng = np.random.default_rng(seed)
    f = np.float32
    return {
        "x": (rng.standard_normal((B, S, H, P)) * 0.5).astype(f),
        "dt": np.log1p(np.exp(rng.standard_normal((B, S, H)) * 0.5
                              + dt_shift)).astype(f),
        "A": (-np.exp(rng.standard_normal(H) * 0.3)).astype(f),
        "Bm": (rng.standard_normal((B, S, N)) * 0.5).astype(f),
        "Cm": (rng.standard_normal((B, S, N)) * 0.5).astype(f),
        "D": (rng.standard_normal(H) * 0.2).astype(f),
    }


def _args(arrs, lib, dtype="float32"):
    """The six arguments in ``lib``'s arrays, x in ``dtype``."""
    names = ("x", "dt", "A", "Bm", "Cm", "D")
    if lib == "jax":
        out = [jnp.asarray(arrs[n]) for n in names]
        out[0] = out[0].astype(dtype)
    else:
        out = [torch.from_numpy(arrs[n]) for n in names]
        out[0] = out[0].to(getattr(torch, dtype))
    return out


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(a, np.float32)


@pytest.mark.parametrize("which", ["naive", "chunked", "pallas"])
@pytest.mark.parametrize("case", CASES)
def test_ssd_matches_reference(case, which):
    B, S, H, P, N, chunk = case
    arrs = _inputs(B, S, H, P, N)
    j, t = _args(arrs, "jax"), _args(arrs, "torch")
    if which == "naive":
        want, got = jax_naive_ssd(*j), naive_ssd(*t)
    elif which == "chunked":
        want, got = jax_ssd_scan(*j, chunk=chunk), ssd_scan(*t, chunk=chunk)
    else:
        before = k4.launches
        want = jax_ssd_pallas(*j, chunk=chunk, interpret=True)
        got = ssd(*t, chunk=chunk, impl="pallas")
        assert k4.launches == before  # CPU tensors: the plain version
    assert got.shape == (B, S, H, P) and got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), _np(want), **TOL)
    # and each against the per-token oracle of the reference
    np.testing.assert_allclose(_np(got), _np(jax_naive_ssd(*j)), **TOL)


@pytest.mark.parametrize("S,chunk", [(96, 64), (80, 64), (200, 128)])
def test_pallas_route_halves_the_chunk_as_reference(S, chunk):
    """A sequence that is not a multiple of the chunk: the kernel's
    route halves the chunk until it divides S, as ``ssd_pallas`` does
    (the chunked scan refuses such a sequence)."""
    arrs = _inputs(1, S, 2, 16, 8, seed=3)
    j, t = _args(arrs, "jax"), _args(arrs, "torch")
    L = k4.chunk_len(S, chunk)
    assert S % L == 0 and L < chunk
    want = jax_ssd_pallas(*j, chunk=chunk, interpret=True)
    got = ssd(*t, chunk=chunk, impl="pallas")
    np.testing.assert_allclose(_np(got), _np(want), **TOL)
    with pytest.raises(AssertionError, match="pad sequence"):
        ssd(*t, chunk=chunk, impl="chunked")


@pytest.mark.parametrize("S,chunk", [(7, 4), (96, 256), (100, 64), (64, 64),
                                     (1, 128), (2048, 256), (2040, 256)])
def test_chunk_len_is_the_reference_kernels(S, chunk):
    L = min(chunk, S)  # src/repro/kernels/ssd/kernel.py:65-67
    while L > 1 and S % L:
        L //= 2
    assert k4.chunk_len(S, chunk) == L


def test_underflowing_decays_match_reference():
    """Large steps (dt about 8, |A| up to 4): exp(A cs) underflows to 0
    within a chunk and across chunks; no NaN, and the same values."""
    arrs = _inputs(2, 128, 3, 32, 16, seed=4, dt_shift=8.0)
    arrs["A"] = arrs["A"] * 3
    assert float((arrs["dt"].sum(1) * -arrs["A"]).min()) > 2000
    j, t = _args(arrs, "jax"), _args(arrs, "torch")
    want = jax_ssd_pallas(*j, chunk=32, interpret=True)
    for impl in ("pallas", "chunked", "reference"):
        got = ssd(*t, chunk=32, impl=impl)
        assert bool(torch.isfinite(got).all()), impl
        np.testing.assert_allclose(_np(got), _np(want), err_msg=impl, **TOL)


@pytest.mark.parametrize("impl", ["pallas", "chunked"])
def test_bf16_x_matches_reference(impl):
    """x (and so y) in bf16, everything else float32, as the model
    calls it."""
    arrs = _inputs(2, 64, 3, 32, 16, seed=5)
    j, t = _args(arrs, "jax", "bfloat16"), _args(arrs, "torch", "bfloat16")
    want = jax_ssd_scan(*j, chunk=32)
    got = ssd(*t, chunk=32, impl=impl)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), _np(want), **BF16_TOL)


def test_front_door_and_wrapper_refuse_what_they_do_not_take():
    t = _args(_inputs(1, 16, 2, 8, 4), "torch")
    with pytest.raises(ValueError, match="unknown ssd impl"):
        ssd(*t, impl="bogus")
    with pytest.raises(ValueError, match="dt has shape"):
        k4.ssd_kernel(t[0], t[1][:, :8], *t[2:])
    # the launch path takes CUDA tensors only: it never runs the plain
    # version on a tensor that is not on the CPU
    with pytest.raises(ValueError, match="one CUDA device"):
        k4.prepare(*t, chunk=8)
