"""The port's LM slice (qwen3-0.6b, dense family) against the JAX package.

Module functions on the same seeded numpy inputs; then the slice as a
whole: the reference's smoke config of qwen3-0.6b with
``attn_impl="pallas"``, JAX parameters from ``PRNGKey(7)`` moved across
with ``params_from_jax``, prefill and greedy decode through both
packages.  In the port ``"pallas"`` runs K2 at prefill and K3 at decode
(their plain versions on CPU tensors); the reference runs its flash
attention kernel in interpret mode at prefill and its chunked scan at
decode (its ``decode_self_attention`` routes ``"pallas"`` there), the
same function.  f32 at the repository's conformance tolerance
(``atol=2e-4, rtol=1e-3``), bf16 at ``2e-2``.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS
from repro.configs import smoke as jax_smoke
from repro.models import common as jcommon
from repro.models import forward as jax_forward
from repro.models import init_caches as jax_init_caches
from repro.models import init_params as jax_init_params
from repro.models import mlp as jmlp
from repro.models import rope as jrope
from repro.serve import engine as jengine
from repro_torch.configs import ARCHS, smoke
from repro_torch.kernels.flash_attention import kernel as k2
from repro_torch.models import (decode_step, forward, init_caches,
                                init_params, params_from_jax)
from repro_torch.models import common, mlp, rope
from repro_torch.serve import engine

TOL = dict(atol=2e-4, rtol=1e-3)
BF16_TOL = dict(atol=2e-2, rtol=2e-2)
B, S0, STEPS, MAX_SEQ = 4, 12, 8, 64  # the shape of examples/serve_lm.py


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x, np.float32)


# ---------------------------------------------------------------------------
# Modules
# ---------------------------------------------------------------------------

def test_configs_are_copies_of_the_reference():
    assert sorted(ARCHS) == sorted(JAX_ARCHS)
    for name in ARCHS:
        assert dataclasses.asdict(ARCHS[name]) == \
            dataclasses.asdict(JAX_ARCHS[name])
        assert dataclasses.asdict(smoke(ARCHS[name])) == \
            dataclasses.asdict(jax_smoke(JAX_ARCHS[name]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_matches_reference(dtype, rng):
    x = rng.standard_normal((3, 5, 64)).astype(np.float32) * 3
    s = rng.standard_normal((64,)).astype(np.float32)
    want = jcommon.rmsnorm(jnp.asarray(x, dtype), jnp.asarray(s), 1e-5)
    got = common.rmsnorm(torch.from_numpy(x).to(getattr(torch, dtype)),
                         torch.from_numpy(s), 1e-5)
    assert got.dtype == getattr(torch, dtype)
    tol = TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(_np(got), _np(want), **tol)


def test_layernorm_matches_reference(rng):
    x = rng.standard_normal((2, 7, 32)).astype(np.float32)
    p = {"scale": rng.standard_normal(32).astype(np.float32),
         "bias": rng.standard_normal(32).astype(np.float32)}
    want = jcommon.layernorm(jnp.asarray(x),
                             {k: jnp.asarray(v) for k, v in p.items()})
    got = common.layernorm(torch.from_numpy(x),
                           {k: torch.from_numpy(v) for k, v in p.items()})
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


@pytest.mark.parametrize("sections", [None, (2, 3, 3)])
def test_apply_rope_matches_reference(sections, rng):
    x = rng.standard_normal((2, 9, 4, 16)).astype(np.float32)
    if sections is None:
        pos = rng.integers(0, 5000, (2, 9)).astype(np.int32)
    else:  # M-RoPE: distinct temporal / height / width components
        pos = rng.integers(0, 5000, (3, 2, 9)).astype(np.int32)
    want = jrope.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta=1e6,
                            mrope_sections=sections)
    got = rope.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                          theta=1e6, mrope_sections=sections)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


def test_mlps_match_reference(rng):
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    p = {"w_gate": rng.standard_normal((64, 128)).astype(np.float32) / 8,
         "w_up": rng.standard_normal((64, 128)).astype(np.float32) / 8,
         "w_down": rng.standard_normal((128, 64)).astype(np.float32) / 11}
    want = jmlp.swiglu({k: jnp.asarray(v) for k, v in p.items()},
                       jnp.asarray(x))
    got = mlp.swiglu({k: torch.from_numpy(v) for k, v in p.items()},
                     torch.from_numpy(x))
    np.testing.assert_allclose(_np(got), _np(want), **TOL)
    g = {"w_in": p["w_gate"], "w_out": p["w_down"]}
    want = jmlp.gelu_mlp({k: jnp.asarray(v) for k, v in g.items()},
                         jnp.asarray(x))
    got = mlp.gelu_mlp({k: torch.from_numpy(v) for k, v in g.items()},
                       torch.from_numpy(x))
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


# ---------------------------------------------------------------------------
# The slice as a whole
# ---------------------------------------------------------------------------

def _configs(dtype="float32"):
    jcfg = jax_smoke(JAX_ARCHS["qwen3-0.6b"]).replace(attn_impl="pallas",
                                                      dtype=dtype)
    tcfg = smoke(ARCHS["qwen3-0.6b"]).replace(attn_impl="pallas",
                                              dtype=dtype)
    return jcfg, tcfg


def _params(jcfg, tcfg):
    jp = jax_init_params(jax.random.PRNGKey(7), jcfg)
    tree = jax.tree.map(np.asarray, jp)
    return jp, params_from_jax(tree, tcfg, device="cpu")


def _prompt(cfg):
    rng = np.random.default_rng(0)
    return rng.integers(0, cfg.vocab, (B, S0)).astype(np.int32)


def test_params_from_jax_splits_the_layer_axis():
    jcfg, tcfg = _configs()
    jp, tp = _params(jcfg, tcfg)
    assert len(tp["blocks"]) == tcfg.n_layers
    wq = np.asarray(jp["blocks"]["attn"]["wq"])
    for i, bp in enumerate(tp["blocks"]):
        np.testing.assert_array_equal(bp["attn"]["wq"].numpy(), wq[i])
        assert bp["attn"]["wq"].shape == (tcfg.d_model,
                                          tcfg.n_heads * tcfg.hd)
    np.testing.assert_array_equal(tp["embed"].numpy(),
                                  np.asarray(jp["embed"]))


@pytest.mark.parametrize("impl", ["pallas", "chunked", "reference"])
def test_prefill_matches_reference(impl):
    jcfg, tcfg = _configs()
    jcfg, tcfg = jcfg.replace(attn_impl=impl), tcfg.replace(attn_impl=impl)
    jp, tp = _params(jcfg, tcfg)
    prompt = _prompt(tcfg)
    want_logits, (want_k, want_v) = jengine.make_prefill_step(
        jcfg, interpret=True)(jp, {"tokens": jnp.asarray(prompt)})
    before = k2.launches
    got_logits, (got_k, got_v) = engine.make_prefill_step(
        tcfg, device="cpu")(tp, {"tokens": torch.from_numpy(prompt)})
    assert k2.launches == before  # CPU tensors: the plain version
    assert got_logits.shape == (B, tcfg.vocab)
    assert got_k.shape == (tcfg.n_layers, B, S0, tcfg.n_kv_heads, tcfg.hd)
    np.testing.assert_allclose(_np(got_logits), _np(want_logits), **TOL)
    np.testing.assert_allclose(_np(got_k), _np(want_k), **TOL)
    np.testing.assert_allclose(_np(got_v), _np(want_v), **TOL)


def test_forward_train_logits_match_reference():
    jcfg, tcfg = _configs()
    jp, tp = _params(jcfg, tcfg)
    prompt = _prompt(tcfg)
    want = jax_forward(jp, {"tokens": jnp.asarray(prompt)}, jcfg,
                       interpret=True)["logits"]
    got = forward(tp, {"tokens": torch.from_numpy(prompt)}, tcfg)["logits"]
    assert got.shape == (B, S0, tcfg.vocab)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


def _jax_step_logits(jp, jcfg, prompt, tokens, cache_dtype):
    """The reference's decode-step logits along a fixed token path: the
    prompt one token at a time, then ``tokens[:, :-1]``."""
    caches = jax_init_caches(jcfg, B, MAX_SEQ, cache_dtype=cache_dtype)
    step = jengine.make_decode_step(jcfg, interpret=True)
    lengths = jnp.zeros((B,), jnp.int32)
    feed = np.concatenate([prompt, tokens[:, :-1]], axis=1)
    out = []
    for t in range(feed.shape[1]):
        lengths = lengths + 1
        logits, caches = step(jp, jnp.asarray(feed[:, t]), caches, lengths)
        out.append(np.asarray(logits, np.float32))
    return out, caches


def test_greedy_decode_matches_reference():
    jcfg, tcfg = _configs()
    jp, tp = _params(jcfg, tcfg)
    prompt = _prompt(tcfg)
    want = np.asarray(jengine.greedy_decode(jp, jcfg, jnp.asarray(prompt),
                                            steps=STEPS, max_seq=MAX_SEQ))
    seen = []
    got = engine.greedy_decode(tp, tcfg, torch.from_numpy(prompt), STEPS,
                               MAX_SEQ, device="cpu", on_logits=seen.append)
    assert got.dtype == torch.int32 and got.shape == (B, STEPS)
    np.testing.assert_array_equal(got.numpy(), want)
    # per-step logits along the same tokens
    want_logits, _ = _jax_step_logits(jp, jcfg, prompt, want, jnp.float32)
    assert len(seen) == len(want_logits) == S0 + STEPS - 1
    for t, (g, w) in enumerate(zip(seen, want_logits)):
        np.testing.assert_allclose(_np(g), w, err_msg=f"step {t}", **TOL)


def test_decode_writes_caches_in_place_as_reference():
    """Four steps: the port's caches (written in place) equal the
    reference's returned caches, and the logits agree."""
    jcfg, tcfg = _configs()
    jp, tp = _params(jcfg, tcfg)
    prompt = _prompt(tcfg)[:, :4]
    want_logits, want_caches = _jax_step_logits(jp, jcfg, prompt[:, :3],
                                                prompt[:, 3:], jnp.float32)
    caches = init_caches(tcfg, B, MAX_SEQ, cache_dtype=torch.float32,
                         device="cpu")
    k_view = caches["k"]
    lengths = torch.zeros((B,), dtype=torch.int32)
    for t in range(3):
        lengths = lengths + 1
        logits = decode_step(tp, torch.from_numpy(prompt[:, t]), caches,
                             lengths, tcfg)
        np.testing.assert_allclose(_np(logits), want_logits[t], **TOL)
    assert caches["k"] is k_view
    np.testing.assert_allclose(_np(caches["k"]), _np(want_caches["k"]), **TOL)
    np.testing.assert_allclose(_np(caches["v"]), _np(want_caches["v"]), **TOL)
    assert not caches["k"][:, :, 3:].any()


def test_decode_past_the_cache_drops_the_write_as_reference():
    """``lengths`` past the cache (caches of 8, ``lengths = [9, 3]``):
    the reference's scatter drops the out-of-range row, so the port keeps
    every row of that sequence's caches as it was, writes the other
    sequence's row 2, and its logits match the reference's."""
    jcfg, tcfg = _configs()
    jp, tp = _params(jcfg, tcfg)
    b, max_seq = 2, 8
    rng = np.random.default_rng(3)
    shape = (tcfg.n_layers, b, max_seq, tcfg.n_kv_heads, tcfg.hd)
    k0 = rng.standard_normal(shape).astype(np.float32)
    v0 = rng.standard_normal(shape).astype(np.float32)
    token = np.array([5, 17], np.int32)
    lengths = np.array([9, 3], np.int32)
    want, want_caches = jengine.make_decode_step(jcfg, interpret=True)(
        jp, jnp.asarray(token), {"k": jnp.asarray(k0), "v": jnp.asarray(v0)},
        jnp.asarray(lengths))
    caches = {"k": torch.from_numpy(k0.copy()),
              "v": torch.from_numpy(v0.copy())}
    got = decode_step(tp, torch.from_numpy(token), caches,
                      torch.from_numpy(lengths), tcfg)
    assert bool(torch.isfinite(got).all())
    np.testing.assert_allclose(_np(got), _np(want), **TOL)
    for name, c0 in (("k", k0), ("v", v0)):
        np.testing.assert_array_equal(caches[name][:, 0].numpy(), c0[:, 0])
        np.testing.assert_allclose(_np(caches[name]), _np(want_caches[name]),
                                   **TOL)
        assert not np.array_equal(caches[name][:, 1, 2].numpy(), c0[:, 1, 2])
        np.testing.assert_array_equal(caches[name][:, 1, 3:].numpy(),
                                      c0[:, 1, 3:])


def test_bf16_prefill_and_decode_match_reference():
    jcfg, tcfg = _configs("bfloat16")
    jp, tp = _params(jcfg, tcfg)
    prompt = _prompt(tcfg)
    want, _ = jengine.make_prefill_step(jcfg, interpret=True)(
        jp, {"tokens": jnp.asarray(prompt)})
    got, _ = engine.make_prefill_step(tcfg, device="cpu")(
        tp, {"tokens": torch.from_numpy(prompt)})
    np.testing.assert_allclose(_np(got), _np(want), **BF16_TOL)
    # decode over a float32 cache (the greedy default): the new K/V are
    # stored in float32 and both packages round them to bf16 to attend
    fixed = np.zeros((B, 2), np.int32)
    want_steps, _ = _jax_step_logits(jp, jcfg, prompt[:, :5], fixed,
                                     jnp.float32)
    caches = init_caches(tcfg, B, MAX_SEQ, cache_dtype=torch.float32,
                         device="cpu")
    lengths = torch.zeros((B,), dtype=torch.int32)
    feed = np.concatenate([prompt[:, :5], fixed[:, :-1]], axis=1)
    for t in range(feed.shape[1]):
        lengths = lengths + 1
        logits = decode_step(tp, torch.from_numpy(feed[:, t]), caches,
                             lengths, tcfg)
        np.testing.assert_allclose(_np(logits), want_steps[t],
                                   err_msg=f"step {t}", **BF16_TOL)


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------

def test_entry_points_raise_without_cuda_unless_asked_for_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, cfg = _configs()
    gen = torch.Generator().manual_seed(0)
    prompt = torch.zeros((1, 2), dtype=torch.int32)
    for call in (lambda: init_params(gen, cfg),
                 lambda: init_caches(cfg, 1, 8),
                 lambda: params_from_jax({}, cfg),
                 lambda: engine.make_prefill_step(cfg),
                 lambda: engine.make_decode_step(cfg),
                 lambda: engine.greedy_decode({}, cfg, prompt, 1, 8)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    params = init_params(gen, cfg, device="cpu")
    out = engine.greedy_decode(params, cfg, prompt, 2, 8, device="cpu")
    assert out.shape == (1, 2)


def test_greedy_decode_validates_like_reference():
    _, cfg = _configs()
    params = init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    with pytest.raises(ValueError, match="at least one prompt token"):
        engine.greedy_decode(params, cfg, torch.zeros((2, 0), dtype=torch.int32),
                             3, 8, device="cpu")
    with pytest.raises(ValueError, match="steps must be >= 0"):
        engine.greedy_decode(params, cfg, torch.zeros((2, 3), dtype=torch.int32),
                             -1, 8, device="cpu")
    with pytest.raises(ValueError, match="> max_seq"):
        engine.greedy_decode(params, cfg, torch.zeros((2, 3), dtype=torch.int32),
                             7, 8, device="cpu")
    out = engine.greedy_decode(params, cfg, torch.zeros((2, 3), dtype=torch.int32),
                               0, 8, device="cpu")
    assert out.shape == (2, 0) and out.dtype == torch.int32


@pytest.mark.parametrize("entry", ["init_params", "init_caches", "forward",
                                   "decode_step", "params_from_jax",
                                   "make_prefill_step", "make_decode_step"])
def test_unknown_family_raises_naming_it(entry):
    """Every family of the reference is ported (tests/test_torch_families.py
    holds moe, encdec and vlm against it); a family the port does not
    know raises a ValueError naming it at each entry point."""
    cfg = smoke(ARCHS["qwen3-0.6b"]).replace(family="retnet")
    tokens = torch.zeros((1, 2), dtype=torch.int32)
    calls = {
        "init_params": lambda: init_params(torch.Generator(), cfg,
                                           device="cpu"),
        "init_caches": lambda: init_caches(cfg, 1, 8, device="cpu"),
        "forward": lambda: forward({}, {"tokens": tokens}, cfg),
        "decode_step": lambda: decode_step({}, tokens[:, 0], {},
                                           tokens[:, 0], cfg),
        "params_from_jax": lambda: params_from_jax({}, cfg, device="cpu"),
        "make_prefill_step": lambda: engine.make_prefill_step(cfg,
                                                              device="cpu"),
        "make_decode_step": lambda: engine.make_decode_step(cfg,
                                                            device="cpu"),
    }
    with pytest.raises(ValueError, match="unknown model family 'retnet'"):
        calls[entry]()
