"""The port's SSD kernel (K4) against its plain version ``ssd_scan``,
which ``tests/test_torch_ssd.py`` holds against the JAX package.  This
file imports no JAX, so its ``cuda``-marked cases run on the card's
machine, which has none.

* ``csrc/ssd.cu`` compiled as host C++ (``g++ -DHFAV_EMULATE``: blocks
  in sequence, a block's threads as host threads meeting at a barrier,
  bf16 by a shim in ``emulate.h``) and held against ``ssd_scan``: the
  64 x 64 tiling and its partial tiles, the u <= t selection, the chunk
  length, strided inputs and the state carried across chunks.
* ``cuda``-marked cases (they skip without a card): the kernel against
  ``ssd_scan`` on the card, and the SSM and hybrid slices with the
  kernels against the plain path on the same weights.

Tolerances: emulated float32 ``atol=2e-5, rtol=1e-4`` (the same float32
arithmetic in another order: the prefix sum of dt in token order where
``ssd_scan`` multiplies by a triangle of ones); on the card float32
``atol=1e-4, rtol=1e-3`` (the card's float32 products sum in other
orders, and an error in cs is multiplied by |A| in an exponent); bf16
``2e-2`` (one bf16 rounding of the output in each version).
"""
from __future__ import annotations

import importlib.util
import pathlib

import numpy as np
import pytest
import torch

from _emulate import _np, emulate_ssd, kernel_library, ssd_inputs
from repro_torch.configs import ARCHS, smoke
from repro_torch.kernels.flash_attention import kernel as k2
from repro_torch.kernels.flash_decode import kernel as k3
from repro_torch.kernels.ssd import kernel as k4
from repro_torch.kernels.ssd import ssd_scan
from repro_torch.models import init_params
from repro_torch.serve import engine

EMU_TOL = dict(atol=2e-5, rtol=1e-4)
CARD_TOL = dict(atol=1e-4, rtol=1e-3)
BF16_TOL = dict(atol=2e-2, rtol=2e-2)
TOL = dict(atol=2e-4, rtol=1e-3)
B, S0, STEPS, MAX_SEQ = 4, 12, 8, 64


# ---------------------------------------------------------------------------
# The CUDA source compiled as host C++
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def emulated():
    """The kernel's library built by ``g++ -DHFAV_EMULATE``."""
    return kernel_library(k4)


# B, S, H, P, N, chunk, x dtype
EMU_CASES = [
    (2, 128, 3, 32, 16, 32, "float32"),    # 4 chunks, one tile each
    (1, 512, 1, 64, 128, 256, "float32"),  # mamba2-130m's P, N and chunk
    (1, 256, 2, 64, 64, 128, "bfloat16"),  # zamba2-2.7b's P and N
    (1, 200, 2, 20, 100, 256, "float32"),  # L = 200: a partial tile
    (2, 96, 2, 16, 8, 64, "float32"),      # S % 64: the chunk halves to 32
    (1, 48, 2, 16, 8, 256, "float32"),     # one chunk shorter than a tile
    (2, 256, 1, 64, 128, 256, "bfloat16"),  # one chunk of 4 tiles
    # 5 chunks; 3 x 2 x 40 x 24 state entries, 22.5 blocks of the state
    # pass
    (3, 320, 2, 24, 40, 64, "float32"),
]


@pytest.mark.parametrize("case", EMU_CASES)
def test_emulated_ssd_matches_plain(case, emulated):
    B, S, H, P, N, chunk, dt = case
    args = ssd_inputs(B, S, H, P, N, seed=1, dtype=getattr(torch, dt))
    got, L = emulate_ssd(emulated, args, chunk)
    want = ssd_scan(*args, chunk=L)
    tol = EMU_TOL if dt == "float32" else BF16_TOL
    np.testing.assert_allclose(_np(got), _np(want), **tol)


@pytest.mark.parametrize("case", EMU_CASES)
def test_emulated_ssd_matches_reference_kernel(case, emulated):
    """The emulated kernel against the JAX package's ``ssd_pallas`` in
    interpret mode on the same inputs (JAX is imported here, not at the
    top, so the file's on-card cases run where there is no JAX)."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels.ssd import ssd_pallas

    B, S, H, P, N, chunk, dt = case
    args = ssd_inputs(B, S, H, P, N, seed=1, dtype=getattr(torch, dt))
    got, _ = emulate_ssd(emulated, args, chunk)
    j = [jnp.asarray(_np(a)) for a in args]
    if dt == "bfloat16":
        j[0] = j[0].astype(jnp.bfloat16)
    want = ssd_pallas(*j, chunk=chunk, interpret=True)
    tol = TOL if dt == "float32" else BF16_TOL
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32), **tol)


def _smoke_gate():
    """``chip_smoke.py``'s ``gated`` and ``SSD_TOL``."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", pathlib.Path(__file__).resolve().parents[1]
        / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.gated, mod.SSD_TOL[torch.float32]


def test_one_tf32_term_misses_the_float32_gate(emulated):
    """The same kernel built with one TF32 product per float32 product
    (``-DSSD_TF32_TERMS=1``) misses ``SSD_TOL`` at mamba2-130m's P, N
    and chunk; the 3xTF32 split of the kernel meets it."""
    gated, tol = _smoke_gate()
    args = ssd_inputs(1, 512, 2, 64, 128, seed=8)
    want = ssd_scan(*args, chunk=256)
    one = kernel_library(k4, ("-DSSD_TF32_TERMS=1",))
    got1, _ = emulate_ssd(one, args, 256)
    with pytest.raises(AssertionError, match="past"):
        gated(got1, want, "one TF32 term", tol)
    got3, _ = emulate_ssd(emulated, args, 256)
    gated(got3, want, "3xTF32", tol)


def test_emulated_ssd_reads_strided_inputs(emulated):
    """x, dt, Bm and Cm as the model leaves them: x a view of a wider
    tensor, dt with stride H along S inside a wider tensor, Bm and Cm
    slices of one projection (stride 2N + 3 along S)."""
    rng = np.random.default_rng(2)
    Bsz, S, H, P, N = 2, 160, 3, 16, 12
    x_full = torch.from_numpy(
        rng.standard_normal((Bsz, S, H, P + 5)).astype(np.float32))
    x = x_full[..., :P]
    dt_full = torch.from_numpy(np.log1p(np.exp(
        rng.standard_normal((Bsz, S, H + 2)) - 1)).astype(np.float32))
    dt = dt_full[..., 1:H + 1]
    proj = torch.from_numpy(
        rng.standard_normal((Bsz, S, 2 * N + 3)).astype(np.float32) * 0.5)
    Bm, Cm = proj[..., :N], proj[..., N + 1:2 * N + 1]
    A = torch.tensor([-0.5, -1.0, -2.0])
    D = torch.tensor([0.1, -0.2, 0.3])
    assert not (x.is_contiguous() or dt.is_contiguous()
                or Bm.is_contiguous() or Cm.is_contiguous())
    got, L = emulate_ssd(emulated, (x, dt, A, Bm, Cm, D), 64)
    want = ssd_scan(x, dt, A, Bm, Cm, D, chunk=L)
    np.testing.assert_allclose(_np(got), _np(want), **EMU_TOL)


def test_emulated_ssd_carries_the_state_across_chunks(emulated):
    """The same sequence cut into 1, 4 and 16 chunks gives the same
    output: the carried state holds the earlier chunks exactly."""
    args = ssd_inputs(1, 256, 2, 32, 32, seed=6)
    outs = [emulate_ssd(emulated, args, chunk)[0] for chunk in (256, 64, 16)]
    for o in outs[1:]:
        np.testing.assert_allclose(_np(o), _np(outs[0]), **EMU_TOL)


def test_emulated_ssd_underflowing_decays(emulated):
    """Steps of about 8 with |A| up to 4: every decay past a few tokens
    underflows to 0, and the exponent for u > t (not computed) would
    overflow; the output is finite and matches."""
    args = ssd_inputs(1, 128, 2, 16, 8, seed=4, dt_shift=8.0)
    args[2] = args[2] * 3
    got, L = emulate_ssd(emulated, args, 64)
    assert bool(torch.isfinite(got).all())
    np.testing.assert_allclose(_np(got), _np(ssd_scan(*args, chunk=L)),
                               **EMU_TOL)


def test_emulated_ssd_refuses_shapes_it_does_not_take(emulated):
    for P, N in ((65, 8), (16, 129)):
        args = ssd_inputs(1, 16, 1, P, N)
        y = torch.empty_like(args[0])
        with pytest.raises(RuntimeError, match="shape not taken"):
            k4.launch(emulated, *args, y, *k4.scratch(args[0], N, 16),
                      L=16, stream=None)


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (run on the GPU)")


@pytest.mark.cuda
@pytest.mark.parametrize("case", EMU_CASES + [
    (4, 2048, 24, 64, 128, 256, "bfloat16"),  # mamba2-130m's prefill
    (2, 1000, 4, 64, 64, 256, "float32")])    # S % 256: chunks of 8
def test_ssd_kernel_matches_plain_on_card(case):
    _need_card()
    B, S, H, P, N, chunk, dt = case
    args = ssd_inputs(B, S, H, P, N, seed=1, device="cuda",
                   dtype=getattr(torch, dt))
    before = k4.launches
    got = k4.ssd_kernel(*args, chunk=chunk)
    torch.cuda.synchronize()
    assert k4.launches == before + 1
    want = ssd_scan(*args, chunk=k4.chunk_len(S, chunk))
    tol = CARD_TOL if dt == "float32" else BF16_TOL
    torch.testing.assert_close(got.float(), want.float(), **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["mamba2-130m", "zamba2-2.7b"])
def test_ssm_slices_on_card_kernels_match_plain_path(name, dtype):
    """Prefill and greedy decode with ``attn_impl="pallas"`` (K4, and K2
    and K3 in the hybrid family) on the card against the same weights
    with ``attn_impl="chunked"``."""
    _need_card()
    cfg = smoke(ARCHS[name]).replace(attn_impl="pallas", dtype=dtype)
    plain = cfg.replace(attn_impl="chunked")
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = init_params(gen, cfg, device="cuda")
    prompt = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (B, 32)).astype(np.int32)).cuda()
    n2, n3, n4 = k2.launches, k3.launches, k4.launches
    got, caches = engine.make_prefill_step(cfg)(params, {"tokens": prompt})
    groups = cfg.n_layers // cfg.hybrid.attn_every if cfg.hybrid else 0
    assert k4.launches == n4 + cfg.n_layers
    assert k2.launches == n2 + groups
    want, want_caches = engine.make_prefill_step(plain)(params,
                                                        {"tokens": prompt})
    tol = TOL if dtype == "float32" else BF16_TOL
    torch.testing.assert_close(got, want, **tol)
    if groups:
        for g, w in zip(caches, want_caches):
            torch.testing.assert_close(g, w, **tol)
    toks = engine.greedy_decode(params, cfg, prompt[:, :S0], STEPS, MAX_SEQ)
    assert k3.launches == n3 + groups * (S0 + STEPS - 1)
    ref_toks = engine.greedy_decode(params, plain, prompt[:, :S0], STEPS,
                                    MAX_SEQ)
    if dtype == "float32":
        assert torch.equal(toks, ref_toks)
