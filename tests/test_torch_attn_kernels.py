"""The port's attention kernels (K2 flash attention, K3 flash decode)
against their plain versions, which ``tests/test_torch_attention.py``
holds against the JAX package.  This file imports no JAX, so its
``cuda``-marked cases run on the card's machine, which has none.

* The CUDA sources compiled as host C++ (``g++ -DHFAV_EMULATE``: blocks
  in sequence, a block's threads as host threads meeting at a barrier,
  bf16 by a shim in ``emulate.h``) and held against the plain versions:
  the kernels' tiling, masking, tile skipping, strides, split and
  combine logic on the CPU.
* ``cuda``-marked cases (they skip without a card): each kernel against
  its plain version on the card, and the LM slice with the kernels
  against the plain path on the same weights.

Tolerances: emulated float32 ``1e-5`` (the same float32 arithmetic in
another order); on the card float32 ``1e-4``; bf16 ``2e-2`` (one bf16
rounding of the output, or of the cached values).
"""
from __future__ import annotations

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCHS, smoke
from repro_torch.kernels.flash_attention import kernel as k2
from repro_torch.kernels.flash_decode import kernel as k3
from repro_torch.models import init_params
from repro_torch.serve import engine

BF16_TOL = dict(atol=2e-2, rtol=2e-2)
TOL = dict(atol=2e-4, rtol=1e-3)
B, S0, STEPS, MAX_SEQ = 4, 12, 8, 64  # the shape of examples/serve_lm.py


def _np(x):
    return x.detach().float().cpu().numpy()


def _torch(a, dtype, device="cpu"):
    return torch.from_numpy(a).to(device=device, dtype=getattr(torch, dtype))


def _attn_inputs(shape_q, shape_kv, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape_q).astype(np.float32),
            rng.standard_normal(shape_kv).astype(np.float32),
            rng.standard_normal(shape_kv).astype(np.float32))


# ---------------------------------------------------------------------------
# The CUDA sources compiled as host C++
# ---------------------------------------------------------------------------

_EMU: dict = {}


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """The two kernels' libraries built by ``g++ -DHFAV_EMULATE``."""
    if shutil.which("g++") is None:
        pytest.skip("no host C++ compiler (g++) to emulate the kernels")
    out = tmp_path_factory.mktemp("emulated_attention")
    libs = {}
    for name, mod in (("fa", k2), ("fd", k3)):
        so = out / f"{name}.so"
        res = subprocess.run(
            ["g++", "-x", "c++", "-std=c++20", "-O1", "-shared", "-fPIC",
             "-pthread", "-DHFAV_EMULATE", "-o", str(so), str(mod.SOURCE)],
            capture_output=True, text=True)
        assert res.returncode == 0, res.stderr[-4000:]
        lib = ctypes.CDLL(str(so))
        mod._bind(lib)
        libs[name] = lib
    return libs


# B, Sq, Skv, H, KVH, D, causal, window, q_offset, dtype
EMU_ATTN_CASES = [
    (1, 70, 70, 2, 1, 32, True, None, 0, "float32"),      # ragged S
    (1, 64, 100, 2, 2, 16, False, None, 36, "float32"),   # Sq < Skv
    (2, 130, 130, 2, 1, 64, True, 20, 0, "float32"),      # masked tiles
    (1, 40, 72, 2, 1, 80, True, None, 32, "bfloat16"),
    (1, 65, 65, 2, 2, 128, False, 30, 0, "float32"),
]


@pytest.mark.parametrize("case", EMU_ATTN_CASES)
def test_emulated_flash_attention_matches_plain(case, emulated):
    B, Sq, Skv, H, KVH, D, causal, window, q_off, dt = case
    q, k, v = _attn_inputs((B, Sq, H, D), (B, Skv, KVH, D), 7)
    q, k, v = _torch(q, dt), _torch(k, dt), _torch(v, dt)
    o = torch.full_like(q, float("nan"))
    blocks = k2.launch(emulated["fa"], q, k, v, o, causal=causal,
                       window=window, q_offset=q_off, scale=D ** -0.5,
                       stream=None)
    assert blocks == B * H * -(-Sq // 64)  # 64 query rows to a block
    want = k2.flash_attention_plain(q, k, v, causal=causal, window=window,
                                    q_offset=q_off, scale=D ** -0.5)
    # f32: reordered sums only; bf16: the same f32 arithmetic, one rounding
    # of the output
    tol = dict(atol=1e-5, rtol=1e-5) if dt == "float32" else BF16_TOL
    np.testing.assert_allclose(_np(o), _np(want), **tol)


def test_emulated_flash_attention_strided_inputs(emulated):
    """q, k, v read in place through their strides: views of one packed
    (B, S, 3, H, D) tensor, as a fused projection would leave them."""
    rng = np.random.default_rng(8)
    qkv = torch.from_numpy(
        rng.standard_normal((1, 50, 3, 2, 32)).astype(np.float32))
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    assert not q.is_contiguous()
    o = torch.empty((1, 50, 2, 32))
    k2.launch(emulated["fa"], q, k, v, o, causal=True, window=None,
              q_offset=0, scale=0.2, stream=None)
    want = k2.flash_attention_plain(q, k, v, causal=True, window=None,
                                    q_offset=0, scale=0.2)
    np.testing.assert_allclose(_np(o), _np(want), atol=1e-5, rtol=1e-5)


# B, S, H, KVH, D, window, chunk, q dtype, cache dtype
EMU_DECODE_CASES = [
    (2, 100, 4, 2, 32, None, 32, "float32", "float32"),
    (3, 64, 4, 4, 16, 24, 16, "float32", "float32"),
    (2, 90, 6, 2, 80, None, 256, "bfloat16", "float32"),
    (2, 90, 8, 1, 64, 40, 32, "bfloat16", "bfloat16"),
    (2, 70, 12, 1, 128, None, 64, "float32", "bfloat16"),
]


@pytest.mark.parametrize("case", EMU_DECODE_CASES)
def test_emulated_flash_decode_matches_plain(case, emulated):
    B, S, H, KVH, D, window, chunk, qdt, cdt = case
    rng = np.random.default_rng(9)
    q = _torch(rng.standard_normal((B, H, D)).astype(np.float32), qdt)
    kc = _torch(rng.standard_normal((B, S, KVH, D)).astype(np.float32), cdt)
    vc = _torch(rng.standard_normal((B, S, KVH, D)).astype(np.float32), cdt)
    lens = rng.integers(1, S + 1, (B,)).astype(np.int32)
    lens[0] = 1
    lens = torch.from_numpy(lens)
    o, ml, acc = k3.buffers(q, S, chunk)
    grids = k3.launch(emulated["fd"], q, kc, vc, lens, o, ml, acc,
                      window=window, scale=D ** -0.5, chunk=chunk,
                      stream=None)
    assert grids == (B * KVH * -(-S // chunk), B * H)
    want = k3.flash_decode_plain(q, kc, vc, lens, window=window,
                                 scale=D ** -0.5)
    tol = dict(atol=1e-5, rtol=1e-5) if qdt == "float32" else BF16_TOL
    np.testing.assert_allclose(_np(o), _np(want), **tol)


def test_emulated_flash_decode_length_past_the_cache(emulated):
    """A length past the cache counts the whole cache, as in the
    reference (whose grid covers only the cache), and reads nothing past
    it: the cache here is a view, and the rows after it are NaN."""
    rng = np.random.default_rng(10)
    S, D = 70, 32
    q = torch.from_numpy(rng.standard_normal((2, 4, D)).astype(np.float32))
    full = torch.full((2, S + 64, 2, D), float("nan"))
    full[:, :S] = torch.from_numpy(
        rng.standard_normal((2, S, 2, D)).astype(np.float32))
    kc = vc = full[:, :S]
    lens = torch.tensor([S + 9, 40], dtype=torch.int32)
    for window in (None, 30):
        o, ml, acc = k3.buffers(q, S, 64)
        k3.launch(emulated["fd"], q, kc, vc, lens, o, ml, acc,
                  window=window, scale=D ** -0.5, chunk=64, stream=None)
        want = k3.flash_decode_plain(q, kc, vc, lens, window=window,
                                     scale=D ** -0.5)
        np.testing.assert_allclose(_np(o), _np(want), atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (run on the GPU)")


@pytest.mark.cuda
@pytest.mark.parametrize("case", EMU_ATTN_CASES + [
    (2, 128, 128, 4, 2, 64, True, None, 0, "bfloat16")])
def test_flash_attention_kernel_matches_plain_on_card(case):
    _need_card()
    B, Sq, Skv, H, KVH, D, causal, window, q_off, dt = case
    q, k, v = _attn_inputs((B, Sq, H, D), (B, Skv, KVH, D), 7)
    q, k, v = (_torch(a, dt, "cuda") for a in (q, k, v))
    before = k2.launches
    got = k2.flash_attention_fwd(q, k, v, causal=causal, window=window,
                                 q_offset=q_off)
    torch.cuda.synchronize()
    assert k2.launches == before + 1
    want = k2.flash_attention_plain(q, k, v, causal=causal, window=window,
                                    q_offset=q_off, scale=D ** -0.5)
    tol = dict(atol=1e-4, rtol=1e-4) if dt == "float32" else BF16_TOL
    torch.testing.assert_close(got.float(), want.float(), **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("case", EMU_DECODE_CASES)
def test_flash_decode_kernel_matches_plain_on_card(case):
    _need_card()
    B, S, H, KVH, D, window, chunk, qdt, cdt = case
    rng = np.random.default_rng(9)
    q = _torch(rng.standard_normal((B, H, D)).astype(np.float32), qdt, "cuda")
    kc = _torch(rng.standard_normal((B, S, KVH, D)).astype(np.float32), cdt,
                "cuda")
    vc = _torch(rng.standard_normal((B, S, KVH, D)).astype(np.float32), cdt,
                "cuda")
    lens = torch.from_numpy(
        rng.integers(1, S + 1, (B,)).astype(np.int32)).cuda()
    before = k3.launches
    got = k3.flash_decode(q, kc, vc, lens, window=window)
    torch.cuda.synchronize()
    assert k3.launches == before + 1
    want = k3.flash_decode_plain(q, kc, vc, lens, window=window,
                                 scale=D ** -0.5)
    tol = dict(atol=1e-4, rtol=1e-4) if qdt == "float32" else BF16_TOL
    torch.testing.assert_close(got.float(), want.float(), **tol)
    # the case's own split size, as the emulated case runs it
    o, ml, acc = k3.buffers(q, S, chunk)
    grids = k3.launch(k3.library(), q, kc, vc, lens.int(), o, ml, acc,
                      window=window, scale=D ** -0.5, chunk=chunk,
                      stream=torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    assert grids == (B * KVH * -(-S // chunk), B * H)
    torch.testing.assert_close(o.float(), want.float(), **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_slice_on_card_kernels_match_plain_path(dtype):
    """Prefill and greedy decode with ``attn_impl="pallas"`` (K2, K3) on
    the card against the same weights with ``attn_impl="reference"``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (run on the GPU)")
    cfg = smoke(ARCHS["qwen3-0.6b"]).replace(attn_impl="pallas", dtype=dtype)
    ref_cfg = cfg.replace(attn_impl="reference")
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = init_params(gen, cfg, device="cuda")
    prompt = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (B, S0)).astype(np.int32)).cuda()
    n2, n3 = k2.launches, k3.launches
    got, _ = engine.make_prefill_step(cfg)(params, {"tokens": prompt})
    assert k2.launches == n2 + cfg.n_layers
    want, _ = engine.make_prefill_step(ref_cfg)(params, {"tokens": prompt})
    tol = TOL if dtype == "float32" else BF16_TOL
    torch.testing.assert_close(got, want, **tol)
    seen, ref_seen = [], []
    toks = engine.greedy_decode(params, cfg, prompt, STEPS, MAX_SEQ,
                                on_logits=seen.append)
    assert k3.launches == n3 + cfg.n_layers * (S0 + STEPS - 1)
    ref_toks = engine.greedy_decode(params, ref_cfg, prompt, STEPS, MAX_SEQ,
                                    on_logits=ref_seen.append)
    if dtype == "float32":
        assert torch.equal(toks, ref_toks)
    # bf16 rounding may pick another token; the prompt steps share a path
    same = len(seen) if torch.equal(toks, ref_toks) else S0
    for g, w in zip(seen[:same], ref_seen[:same]):
        torch.testing.assert_close(g, w, **tol)
