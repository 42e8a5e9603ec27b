"""The port's SSM slice (mamba2-130m, the ssm family) and the hybrid
family (zamba2-2.7b) against the JAX package.

Module functions on the same seeded numpy inputs; then each model as a
whole under the reference's smoke config, JAX parameters from
``PRNGKey(7)`` moved across with ``params_from_jax``: train logits,
prefill logits (and the hybrid family's shared-block caches), greedy
decode tokens and per-step logits, and decode against the port's own
teacher-forced forward, for ``attn_impl`` in ``"pallas"``,
``"chunked"`` and ``"reference"``.  In the port ``"pallas"`` runs K4 at
prefill (and K2 at prefill, K3 at decode in the hybrid family), their
plain versions on CPU tensors; the reference sends ``"pallas"`` to its
chunked SSD scan and its chunked decode attention, the same functions.
float32 at the repository's conformance tolerance (``atol=2e-4,
rtol=1e-3``), decode against forward at ``tests/test_models.py``'s
``2e-3`` (two algorithms: the chunked scan against the per-token
recurrence), bf16 modules at ``2e-2`` and bf16 models as
``BF16_FACTOR`` says.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS
from repro.configs import smoke as jax_smoke
from repro.models import forward as jax_forward
from repro.models import init_caches as jax_init_caches
from repro.models import init_params as jax_init_params
from repro.models import ssm as jssm
from repro.serve import engine as jengine
from repro_torch.configs import ARCHS, smoke
from repro_torch.kernels.ssd import kernel as k4
from repro_torch.models import (decode_step, forward, init_caches,
                                init_params, params_from_jax)
from repro_torch.models import ssm
from repro_torch.serve import engine

TOL = dict(atol=2e-4, rtol=1e-3)
TEACHER_TOL = dict(atol=2e-3, rtol=2e-3)
BF16_TOL = dict(atol=2e-2, rtol=2e-2)
# Whole-model bf16 logits are held against the float32 logits, not
# against the reference's bf16 logits: the two packages round to bf16 in
# different places (XLA fuses elementwise chains that PyTorch rounds op
# by op), and at zamba2-2.7b's smoke config each package's bf16 logits
# are several percent (relative L2) from the float32 logits, so the two
# bf16 results may be further apart than either is from the float32
# one.  Over prefill and six decode steps together, as
# test_bf16_prefill_and_decode_match_reference measures it, the port's
# bf16 error is 0.78x the reference's at zamba2-2.7b and 1.03x at
# mamba2-130m.
BF16_FACTOR = 1.5
B, S0, STEPS, MAX_SEQ = 4, 8, 6, 64
PROMPT = 32  # two smoke chunks of 16
ARCH_NAMES = ["mamba2-130m", "zamba2-2.7b"]
IMPLS = ["pallas", "chunked", "reference"]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x, np.float32)


def _configs(name, impl="pallas", dtype="float32"):
    return (jax_smoke(JAX_ARCHS[name]).replace(attn_impl=impl, dtype=dtype),
            smoke(ARCHS[name]).replace(attn_impl=impl, dtype=dtype))


def _params(jcfg, tcfg):
    jp = jax_init_params(jax.random.PRNGKey(7), jcfg)
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), tcfg,
                               device="cpu")


def _prompt(cfg, width=PROMPT):
    rng = np.random.default_rng(0)
    return rng.integers(0, cfg.vocab, (B, width)).astype(np.int32)


# ---------------------------------------------------------------------------
# Modules
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_causal_conv_matches_reference(dtype, rng):
    x = rng.standard_normal((2, 9, 32)).astype(np.float32)
    w = rng.standard_normal((4, 32)).astype(np.float32)
    b = rng.standard_normal(32).astype(np.float32)
    want = jssm._causal_conv(*(jnp.asarray(a, dtype) for a in (x, w, b)))
    tdt = getattr(torch, dtype)
    got = ssm._causal_conv(*(torch.from_numpy(a).to(tdt) for a in (x, w, b)))
    assert got.dtype == tdt
    tol = TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(_np(got), _np(want), **tol)


def _mamba(name):
    jcfg, tcfg = _configs(name, "chunked")
    jp = jssm.mamba_init(jax.random.PRNGKey(3), jcfg)
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    return jcfg, tcfg, jp, tp


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_mamba_forward_matches_reference(name, rng):
    jcfg, tcfg, jp, tp = _mamba(name)
    x = rng.standard_normal((2, 32, tcfg.d_model)).astype(np.float32)
    want = jssm.mamba_forward(jp, jnp.asarray(x), jcfg)
    got = ssm.mamba_forward(tp, torch.from_numpy(x), tcfg)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_mamba_decode_step_updates_the_cache_in_place_as_reference(name, rng):
    jcfg, tcfg, jp, tp = _mamba(name)
    jcache = jssm.mamba_cache_init(jcfg, 2, jnp.float32)
    tcache = ssm.mamba_cache_init(tcfg, 2, torch.float32, layers=1)
    tcache = {k: v[0] for k, v in tcache.items()}  # one layer's views
    assert {k: tuple(v.shape) for k, v in tcache.items()} == \
        {k: v.shape for k, v in jcache.items()}
    views = dict(tcache)
    for _ in range(3):
        x = rng.standard_normal((2, tcfg.d_model)).astype(np.float32)
        want, jcache = jssm.mamba_decode_step(jp, jnp.asarray(x), jcache,
                                              jcfg)
        got = ssm.mamba_decode_step(tp, torch.from_numpy(x), tcache, tcfg)
        np.testing.assert_allclose(_np(got), _np(want), **TOL)
    for k in jcache:
        assert tcache[k] is views[k]
        np.testing.assert_allclose(_np(tcache[k]), _np(jcache[k]), **TOL)


# ---------------------------------------------------------------------------
# The models as a whole
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ARCH_NAMES)
def test_params_from_jax_carries_every_weight(name):
    jcfg, tcfg = _configs(name)
    jp, tp = _params(jcfg, tcfg)
    assert len(tp["blocks"]) == tcfg.n_layers
    jleaves = jax.tree_util.tree_leaves_with_path(jp)
    for path, leaf in jleaves:
        keys = [p.key for p in path]
        if keys[0] == "blocks":
            for i, bp in enumerate(tp["blocks"]):
                got = bp
                for k in keys[1:]:
                    got = got[k]
                np.testing.assert_array_equal(got.numpy(),
                                              np.asarray(leaf)[i])
        else:
            got = tp
            for k in keys:
                got = got[k]
            np.testing.assert_array_equal(got.numpy(), np.asarray(leaf))
    assert ("shared_attn" in tp) == (tcfg.family == "hybrid")


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_init_caches_match_reference_layout(name):
    jcfg, tcfg = _configs(name)
    want = jax.tree.map(lambda a: (a.shape, str(a.dtype)),
                        jax_init_caches(jcfg, B, MAX_SEQ,
                                        cache_dtype=jnp.float32))
    got = init_caches(tcfg, B, MAX_SEQ, cache_dtype=torch.float32,
                      device="cpu")
    got = jax.tree.map(lambda t: (tuple(t.shape),
                                  str(t.dtype).replace("torch.", "")), got)
    assert got == want


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("name", ARCH_NAMES)
def test_prefill_matches_reference(name, impl):
    jcfg, tcfg = _configs(name, impl)
    jp, tp = _params(jcfg, tcfg)
    prompt = _prompt(tcfg)
    want_logits, want_caches = jengine.make_prefill_step(
        jcfg, interpret=True)(jp, {"tokens": jnp.asarray(prompt)})
    before = k4.launches
    got_logits, got_caches = engine.make_prefill_step(tcfg, device="cpu")(
        tp, {"tokens": torch.from_numpy(prompt)})
    assert k4.launches == before  # CPU tensors: the plain version
    assert got_logits.shape == (B, tcfg.vocab)
    np.testing.assert_allclose(_np(got_logits), _np(want_logits), **TOL)
    if tcfg.family == "ssm":
        assert got_caches is None and want_caches is None
    else:
        groups = tcfg.n_layers // tcfg.hybrid.attn_every
        assert got_caches[0].shape == (groups, B, PROMPT, tcfg.n_kv_heads,
                                       tcfg.hd)
        for g, w in zip(got_caches, want_caches):
            np.testing.assert_allclose(_np(g), _np(w), **TOL)


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("name", ARCH_NAMES)
def test_forward_train_logits_match_reference(name, impl):
    jcfg, tcfg = _configs(name, impl)
    jp, tp = _params(jcfg, tcfg)
    prompt = _prompt(tcfg)
    want = jax_forward(jp, {"tokens": jnp.asarray(prompt)}, jcfg,
                       interpret=True)["logits"]
    got = forward(tp, {"tokens": torch.from_numpy(prompt)}, tcfg)
    assert "caches" not in got
    assert got["logits"].shape == (B, PROMPT, tcfg.vocab)
    np.testing.assert_allclose(_np(got["logits"]), _np(want), **TOL)


def _jax_step_logits(jp, jcfg, feed, cache_dtype=jnp.float32):
    """The reference's decode-step logits along ``feed`` (B, T), one
    token at a time."""
    caches = jax_init_caches(jcfg, B, MAX_SEQ, cache_dtype=cache_dtype)
    step = jengine.make_decode_step(jcfg, interpret=True)
    lengths = jnp.zeros((B,), jnp.int32)
    out = []
    for t in range(feed.shape[1]):
        lengths = lengths + 1
        logits, caches = step(jp, jnp.asarray(feed[:, t]), caches, lengths)
        out.append(np.asarray(logits, np.float32))
    return out, caches


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("name", ARCH_NAMES)
def test_greedy_decode_matches_reference(name, impl):
    jcfg, tcfg = _configs(name, impl)
    jp, tp = _params(jcfg, tcfg)
    prompt = _prompt(tcfg, S0)
    want = np.asarray(jengine.greedy_decode(jp, jcfg, jnp.asarray(prompt),
                                            steps=STEPS, max_seq=MAX_SEQ))
    seen = []
    got = engine.greedy_decode(tp, tcfg, torch.from_numpy(prompt), STEPS,
                               MAX_SEQ, device="cpu", on_logits=seen.append)
    assert got.dtype == torch.int32 and got.shape == (B, STEPS)
    np.testing.assert_array_equal(got.numpy(), want)
    feed = np.concatenate([prompt, want[:, :-1]], axis=1)
    want_logits, _ = _jax_step_logits(jp, jcfg, feed)
    assert len(seen) == len(want_logits) == S0 + STEPS - 1
    for t, (g, w) in enumerate(zip(seen, want_logits)):
        np.testing.assert_allclose(_np(g), w, err_msg=f"step {t}", **TOL)


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("name", ARCH_NAMES)
def test_decode_matches_forward(name, impl):
    """Teacher forcing (``tests/test_models.py::test_decode_matches_forward``
    on the port): the tokens one by one through ``decode_step`` give
    the forward pass's logits, which pins the rolling conv window, the
    SSM state and the hybrid family's shared-block caches at once."""
    _, tcfg = _configs(name, impl)
    params = init_params(torch.Generator().manual_seed(1), tcfg,
                         device="cpu")
    tokens = torch.from_numpy(_prompt(tcfg, 16))
    want = forward(params, {"tokens": tokens}, tcfg)["logits"]
    caches = init_caches(tcfg, B, MAX_SEQ, cache_dtype=torch.float32,
                         device="cpu")
    lengths = torch.zeros((B,), dtype=torch.int32)
    got = []
    for t in range(tokens.shape[1]):
        lengths = lengths + 1
        got.append(decode_step(params, tokens[:, t], caches, lengths, tcfg))
    np.testing.assert_allclose(_np(torch.stack(got, dim=1)), _np(want),
                               **TEACHER_TOL)


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_decode_writes_caches_in_place_as_reference(name):
    """Four steps: the port's caches (written in place) equal the
    reference's returned caches."""
    jcfg, tcfg = _configs(name)
    jp, tp = _params(jcfg, tcfg)
    feed = _prompt(tcfg, 4)
    want_logits, want_caches = _jax_step_logits(jp, jcfg, feed)
    caches = init_caches(tcfg, B, MAX_SEQ, cache_dtype=torch.float32,
                         device="cpu")
    before = jax.tree.map(lambda t: t, caches)  # the same tensor objects
    lengths = torch.zeros((B,), dtype=torch.int32)
    for t in range(4):
        lengths = lengths + 1
        logits = decode_step(tp, torch.from_numpy(feed[:, t]), caches,
                             lengths, tcfg)
        np.testing.assert_allclose(_np(logits), want_logits[t], **TOL)
    got_leaves = jax.tree_util.tree_leaves(caches)
    for g, b in zip(got_leaves, jax.tree_util.tree_leaves(before)):
        assert g is b
    for g, w in zip(got_leaves, jax.tree_util.tree_leaves(want_caches)):
        np.testing.assert_allclose(_np(g), _np(w), **TOL)


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_bf16_prefill_and_decode_match_reference(name):
    """bf16 prefill and six decode steps: over all their logits
    together, the port's are no farther from the float32 logits than
    ``BF16_FACTOR`` times the reference's bf16 logits are."""
    jcfg, tcfg = _configs(name, "pallas", "bfloat16")
    jp, tp = _params(jcfg, tcfg)
    j32 = jcfg.replace(dtype="float32")
    prompt = _prompt(tcfg)
    batch = {"tokens": jnp.asarray(prompt)}
    want = [jengine.make_prefill_step(jcfg, interpret=True)(jp, batch)[0]]
    want32 = [jengine.make_prefill_step(j32, interpret=True)(jp, batch)[0]]
    got = [engine.make_prefill_step(tcfg, device="cpu")(
        tp, {"tokens": torch.from_numpy(prompt)})[0]]
    feed = prompt[:, :6]
    want += _jax_step_logits(jp, jcfg, feed)[0]
    want32 += _jax_step_logits(jp, j32, feed)[0]
    caches = init_caches(tcfg, B, MAX_SEQ, cache_dtype=torch.float32,
                         device="cpu")
    lengths = torch.zeros((B,), dtype=torch.int32)
    for t in range(feed.shape[1]):
        lengths = lengths + 1
        got.append(decode_step(tp, torch.from_numpy(feed[:, t]), caches,
                               lengths, tcfg))
    got, want, want32 = (np.stack([_np(a) for a in xs])
                         for xs in (got, want, want32))
    assert got.shape == (7, B, tcfg.vocab) and np.isfinite(got).all()
    ours = np.linalg.norm(got - want32)
    theirs = np.linalg.norm(want - want32)
    assert ours <= BF16_FACTOR * theirs, (ours, theirs)
