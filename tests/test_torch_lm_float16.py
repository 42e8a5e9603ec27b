"""The LM slices in float16 against the JAX package in float16: the smoke
qwen3-0.6b (K2 and K3's plain versions, ``attn_impl="pallas"``) and
mamba2-130m (K4's) configs, prefill and greedy decode on the same
weights (``params_from_jax``).

The reference takes ``cfg.dtype = "float16"`` for every model; its
kernels upcast to float32 and write their outputs in float16, as the
port's do.  The tolerance is bf16's ``2e-2`` divided by 8 (float16's
step is bf16's divided by 8), ``atol = rtol = 2.5e-3``, and the whole
logits within a relative L2 of ``5e-3`` (measured on the CPU: 9.9e-4 at
qwen3-0.6b, 2.2e-3 at mamba2-130m, where bf16 gives 9.4e-3 and 1.1e-2).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS
from repro.configs import smoke as jax_smoke
from repro.models import init_caches as jax_init_caches
from repro.models import init_params as jax_init_params
from repro.serve import engine as jengine
from repro_torch.configs import ARCHS, smoke
from repro_torch.models import decode_step, init_caches, params_from_jax
from repro_torch.serve import engine

FP16_TOL = dict(atol=2.5e-3, rtol=2.5e-3)
FP16_REL_L2 = 5e-3
B, S0, STEPS, MAX_SEQ = 4, 12, 8, 64
#: (arch, prefill length): mamba2-130m's smoke chunk is 16
PATHS = [("qwen3-0.6b", 12), ("mamba2-130m", 32)]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x, np.float32)


def _rel_l2(got, want) -> float:
    g, w = _np(got).astype(np.float64), _np(want).astype(np.float64)
    return float(np.linalg.norm(g - w) / np.linalg.norm(w))


def _setup(name):
    jcfg = jax_smoke(JAX_ARCHS[name]).replace(attn_impl="pallas",
                                              dtype="float16")
    tcfg = smoke(ARCHS[name]).replace(attn_impl="pallas", dtype="float16")
    jp = jax_init_params(jax.random.PRNGKey(7), jcfg)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    return jcfg, tcfg, jp, tp


def _prompt(cfg, width):
    rng = np.random.default_rng(0)
    return rng.integers(0, cfg.vocab, (B, width)).astype(np.int32)


@pytest.mark.parametrize("name,width", PATHS)
def test_float16_prefill_matches_reference(name, width):
    jcfg, tcfg, jp, tp = _setup(name)
    prompt = _prompt(tcfg, width)
    want, _ = jengine.make_prefill_step(jcfg, interpret=True)(
        jp, {"tokens": jnp.asarray(prompt)})
    got, _ = engine.make_prefill_step(tcfg, device="cpu")(
        tp, {"tokens": torch.from_numpy(prompt)})
    assert np.isfinite(_np(got)).all()
    np.testing.assert_allclose(_np(got), _np(want), **FP16_TOL)
    assert _rel_l2(got, want) < FP16_REL_L2


@pytest.mark.parametrize("name", [n for n, _ in PATHS])
def test_float16_greedy_decode_matches_reference(name):
    """Greedy decode (float32 caches, ``greedy_decode``'s default: both
    packages round the cached K/V to float16 to attend): the same tokens,
    and every step's logits along them within the float16 tolerance."""
    jcfg, tcfg, jp, tp = _setup(name)
    prompt = _prompt(tcfg, S0)
    want = np.asarray(jengine.greedy_decode(jp, jcfg, jnp.asarray(prompt),
                                            steps=STEPS, max_seq=MAX_SEQ))
    seen = []
    got = engine.greedy_decode(tp, tcfg, torch.from_numpy(prompt), STEPS,
                               MAX_SEQ, device="cpu", on_logits=seen.append)
    np.testing.assert_array_equal(got.numpy(), want)
    caches = jax_init_caches(jcfg, B, MAX_SEQ, cache_dtype=jnp.float32)
    step = jengine.make_decode_step(jcfg, interpret=True)
    lengths = jnp.zeros((B,), jnp.int32)
    feed = np.concatenate([prompt, want[:, :-1]], axis=1)
    assert len(seen) == feed.shape[1]
    for t in range(feed.shape[1]):
        lengths = lengths + 1
        logits, caches = step(jp, jnp.asarray(feed[:, t]), caches, lengths)
        np.testing.assert_allclose(_np(seen[t]), _np(logits),
                                   err_msg=f"step {t}", **FP16_TOL)


def test_float16_decode_over_bf16_caches_matches_reference():
    """qwen3-0.6b's float16 decode steps over bf16 caches (``init_caches``'
    default, as the card's main path runs them): both packages round the
    cached bf16 values to float16 before attending."""
    jcfg, tcfg, jp, tp = _setup("qwen3-0.6b")
    feed = _prompt(tcfg, 6)
    jc = jax_init_caches(jcfg, B, MAX_SEQ, cache_dtype=jnp.bfloat16)
    step = jengine.make_decode_step(jcfg, interpret=True)
    tc = init_caches(tcfg, B, MAX_SEQ, cache_dtype=torch.bfloat16,
                     device="cpu")
    jl = jnp.zeros((B,), jnp.int32)
    tl = torch.zeros((B,), dtype=torch.int32)
    for t in range(feed.shape[1]):
        jl, tl = jl + 1, tl + 1
        want, jc = step(jp, jnp.asarray(feed[:, t]), jc, jl)
        got = decode_step(tp, torch.from_numpy(feed[:, t]), tc, tl, tcfg)
        np.testing.assert_allclose(_np(got), _np(want), err_msg=f"step {t}",
                                   **FP16_TOL)
