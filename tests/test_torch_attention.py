"""The port's attention kernels against the JAX package.

* K2 (flash attention) and K3 (flash decode): the wrappers on CPU
  tensors run their plain versions, held against the reference's Pallas
  kernels in interpret mode and its dense oracles, on the same seeded
  numpy inputs.  f32 at the reference's own kernel tolerance
  (``atol=2e-5, rtol=1e-4``, tests/test_kernels.py), bf16 at ``2e-2``.
* The port's ``dense``/``chunked`` implementations and front doors
  against the reference's.

The CUDA kernels themselves are held against these plain versions in
``tests/test_torch_attn_kernels.py`` (host emulation and the card).

Finite sentinels: masked scores are -1e30 in both packages, not -inf;
with -inf a fully masked tile gives exp(-inf - -inf) = NaN.  The cases
with a window narrower than the kernels' 64-key tile (``window=20`` at
S=200) have fully masked tiles, which the CUDA kernel skips and the
reference computes; both give the same result because every row keeps
one unmasked key.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import chunked_attention as jax_chunked
from repro.kernels.flash_attention import dense_attention as jax_dense
from repro.kernels.flash_attention import flash_attention_fwd as jax_fa
from repro.kernels.flash_attention.ops import attention as jax_attention
from repro.kernels.flash_decode import decode_attention as jax_decode
from repro.kernels.flash_decode import flash_decode as jax_fd
from repro_torch.kernels.flash_attention import kernel as k2
from repro_torch.kernels.flash_attention.ops import attention, chunked_attention
from repro_torch.kernels.flash_attention.ref import dense_attention
from repro_torch.kernels.flash_decode import kernel as k3
from repro_torch.kernels.flash_decode.ops import decode_attention

F32_TOL = dict(atol=2e-5, rtol=1e-4)
BF16_TOL = dict(atol=2e-2, rtol=2e-2)

# B, Sq, Skv, H, KVH, D, causal, window, dtype: the cases of
# tests/test_kernels.py (ATTN_CASES), then a ragged S, a window that masks
# whole tiles, and head dims 80 and 16
ATTN_CASES = [
    (2, 128, 128, 4, 2, 64, True, None, "float32"),
    (1, 256, 256, 8, 8, 32, False, None, "float32"),
    (2, 128, 128, 6, 2, 64, True, 48, "float32"),
    (1, 64, 192, 4, 1, 128, False, None, "float32"),
    (2, 128, 128, 4, 2, 64, True, None, "bfloat16"),
    (1, 100, 100, 4, 2, 32, True, None, "float32"),
    (1, 200, 200, 2, 1, 16, True, 20, "float32"),
    (1, 96, 96, 2, 2, 80, False, 40, "float32"),
]

# B, S, H, KVH, D, window: the cases of tests/test_kernels.py, then a
# bf16 cache and a window narrower than a KV block
DECODE_CASES = [
    (2, 512, 8, 2, 64, None, "float32"),
    (3, 256, 4, 4, 32, 96, "float32"),
    (1, 384, 6, 3, 128, None, "float32"),
    (2, 256, 4, 2, 64, None, "bfloat16"),
    (3, 200, 4, 1, 16, 7, "float32"),
]


def _jax(a, dtype):
    return jnp.asarray(a, getattr(jnp, dtype))


def _torch(a, dtype, device="cpu"):
    return torch.from_numpy(a).to(device=device, dtype=getattr(torch, dtype))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x, np.float32)


def _attn_inputs(case, seed=0):
    B, Sq, Skv, H, KVH, D, causal, window, dt = case
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Sq, H, D)).astype(np.float32)
    k = rng.standard_normal((B, Skv, KVH, D)).astype(np.float32)
    v = rng.standard_normal((B, Skv, KVH, D)).astype(np.float32)
    return q, k, v


def _tol(dtype):
    return BF16_TOL if dtype == "bfloat16" else F32_TOL


# ---------------------------------------------------------------------------
# K2 and its front door against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ATTN_CASES)
def test_flash_attention_plain_matches_pallas_interpret(case):
    B, Sq, Skv, H, KVH, D, causal, window, dt = case
    q, k, v = _attn_inputs(case)
    want = jax_fa(_jax(q, dt), _jax(k, dt), _jax(v, dt), causal=causal,
                  window=window, interpret=True)
    got = k2.flash_attention_fwd(_torch(q, dt), _torch(k, dt), _torch(v, dt),
                                 causal=causal, window=window)
    assert got.dtype == getattr(torch, dt) and got.shape == q.shape
    np.testing.assert_allclose(_np(got), _np(want), **_tol(dt))


@pytest.mark.parametrize("case", ATTN_CASES)
def test_flash_attention_plain_matches_dense_oracle(case):
    B, Sq, Skv, H, KVH, D, causal, window, dt = case
    q, k, v = _attn_inputs(case, seed=1)
    want = jax_dense(_jax(q, dt), _jax(k, dt), _jax(v, dt), causal=causal,
                     window=window)
    got = k2.flash_attention_fwd(_torch(q, dt), _torch(k, dt), _torch(v, dt),
                                 causal=causal, window=window)
    np.testing.assert_allclose(_np(got), _np(want), **_tol(dt))


@pytest.mark.parametrize("q_offset", [0, None])
@pytest.mark.parametrize("window", [None, 24])
def test_flash_attention_q_offset(q_offset, window):
    """``self_attention`` passes ``q_offset=0``; the kernel's default is
    ``Skv - Sq``.  Both against the reference kernel, Sq < Skv."""
    case = (1, 48, 112, 4, 2, 32, True, window, "float32")
    q, k, v = _attn_inputs(case, seed=2)
    want = jax_fa(_jax(q, "float32"), _jax(k, "float32"), _jax(v, "float32"),
                  causal=True, window=window, q_offset=q_offset,
                  interpret=True)
    got = k2.flash_attention_fwd(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v), causal=True,
                                 window=window, q_offset=q_offset)
    np.testing.assert_allclose(_np(got), _np(want), **F32_TOL)


@pytest.mark.parametrize("impl", ["reference", "chunked", "pallas"])
@pytest.mark.parametrize("case", [ATTN_CASES[0], ATTN_CASES[2],
                                  ATTN_CASES[4], ATTN_CASES[5]])
def test_attention_front_door_matches_reference(impl, case):
    B, Sq, Skv, H, KVH, D, causal, window, dt = case
    q, k, v = _attn_inputs(case, seed=3)
    want = jax_attention(_jax(q, dt), _jax(k, dt), _jax(v, dt), causal=causal,
                         window=window, impl=impl, chunk=64, interpret=True)
    got = attention(_torch(q, dt), _torch(k, dt), _torch(v, dt),
                    causal=causal, window=window, impl=impl, chunk=64)
    np.testing.assert_allclose(_np(got), _np(want), **_tol(dt))


def test_chunked_attention_kv_len_and_qpos():
    """The decode form of the chunked scan: explicit query positions and
    per-sequence valid lengths."""
    rng = np.random.default_rng(4)
    q = rng.standard_normal((3, 1, 4, 32)).astype(np.float32)
    k = rng.standard_normal((3, 96, 2, 32)).astype(np.float32)
    v = rng.standard_normal((3, 96, 2, 32)).astype(np.float32)
    lens = np.array([5, 96, 40], np.int32)
    want = jax_chunked(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                       kv_len=jnp.asarray(lens),
                       qpos=jnp.asarray(lens - 1)[:, None], window=30,
                       chunk=32)
    got = chunked_attention(torch.from_numpy(q), torch.from_numpy(k),
                            torch.from_numpy(v),
                            kv_len=torch.from_numpy(lens),
                            qpos=torch.from_numpy(lens - 1)[:, None],
                            window=30, chunk=32)
    np.testing.assert_allclose(_np(got), _np(want), **F32_TOL)
    dense = dense_attention(torch.from_numpy(q), torch.from_numpy(k),
                            torch.from_numpy(v),
                            kv_len=torch.from_numpy(lens),
                            qpos=torch.from_numpy(lens - 1)[:, None],
                            window=30)
    np.testing.assert_allclose(_np(got), _np(dense), **F32_TOL)


@pytest.mark.parametrize("bad, match", [
    (dict(window=0), "window"),
    (dict(k_shape=(1, 16, 3, 16)), "group"),
    (dict(k_shape=(1, 16, 2, 32)), "head dim"),
])
def test_flash_attention_rejects_bad_arguments(bad, match):
    q = torch.zeros((1, 16, 4, 16))
    k = torch.zeros(bad.get("k_shape", (1, 16, 2, 16)))
    with pytest.raises(ValueError, match=match):
        k2.flash_attention_fwd(q, k, k.clone(), window=bad.get("window"))


# ---------------------------------------------------------------------------
# K3 and its front door against the reference
# ---------------------------------------------------------------------------

def _decode_inputs(case, seed=0):
    B, S, H, KVH, D, window, cdt = case
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    kc = rng.standard_normal((B, S, KVH, D)).astype(np.float32)
    vc = rng.standard_normal((B, S, KVH, D)).astype(np.float32)
    lens = rng.integers(S // 3, S, (B,)).astype(np.int32)
    lens[0] = 1  # a sequence with only its new token
    return q, kc, vc, lens


@pytest.mark.parametrize("case", DECODE_CASES)
def test_flash_decode_plain_matches_pallas_interpret(case):
    B, S, H, KVH, D, window, cdt = case
    q, kc, vc, lens = _decode_inputs(case)
    want = jax_fd(_jax(q, cdt), _jax(kc, cdt), _jax(vc, cdt),
                  jnp.asarray(lens), window=window, interpret=True)
    got = k3.flash_decode(_torch(q, cdt), _torch(kc, cdt), _torch(vc, cdt),
                          torch.from_numpy(lens), window=window)
    assert got.dtype == getattr(torch, cdt) and got.shape == q.shape
    np.testing.assert_allclose(_np(got), _np(want), **_tol(cdt))


def test_flash_decode_bf16_query_rounds_a_float32_cache():
    """Compute dtype bf16 over a float32 cache: the reference casts the
    cache to bf16 before attending, and so do both versions of K3."""
    case = (2, 128, 4, 2, 32, None, "float32")
    q, kc, vc, lens = _decode_inputs(case, seed=5)
    want = jax_fd(_jax(q, "bfloat16"), _jax(kc, "bfloat16"),
                  _jax(vc, "bfloat16"), jnp.asarray(lens), interpret=True)
    got = k3.flash_decode(_torch(q, "bfloat16"), torch.from_numpy(kc),
                          torch.from_numpy(vc), torch.from_numpy(lens))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), _np(want), **BF16_TOL)


@pytest.mark.parametrize("impl", ["reference", "chunked", "pallas"])
@pytest.mark.parametrize("case", DECODE_CASES[:3])
def test_decode_front_door_matches_reference(impl, case):
    B, S, H, KVH, D, window, cdt = case
    q, kc, vc, lens = _decode_inputs(case, seed=6)
    want = jax_decode(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
                      jnp.asarray(lens), window=window, impl=impl, chunk=64,
                      interpret=True)
    got = decode_attention(torch.from_numpy(q), torch.from_numpy(kc),
                           torch.from_numpy(vc), torch.from_numpy(lens),
                           window=window, impl=impl, chunk=64)
    np.testing.assert_allclose(_np(got), _np(want), **F32_TOL)


def test_flash_decode_rejects_bad_arguments():
    q = torch.zeros((2, 4, 16))
    kc = torch.zeros((2, 32, 2, 16))
    with pytest.raises(ValueError, match="lengths"):
        k3.flash_decode(q, kc, kc, torch.ones(3, dtype=torch.int32))
    with pytest.raises(ValueError, match="window"):
        k3.flash_decode(q, kc, kc, torch.ones(2, dtype=torch.int32), window=0)
