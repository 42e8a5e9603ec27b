"""The port's moe, encdec and vlm families against the JAX package.

Module functions first (``sinusoidal_positions``, ``sinusoidal_at``,
``cross_attention`` at one query row and at Sq < Skv), then each family
as a whole: the reference's smoke configs of mixtral-8x7b and
granite-moe-3b-a800m (moe), whisper-small (encdec) and qwen2-vl-72b
(vlm) with ``attn_impl="pallas"``, JAX parameters from ``PRNGKey(7)``
moved across with ``params_from_jax``, the same seeded numpy tokens
(and whisper's stub frame embeddings) through both packages.  In the
port ``"pallas"`` runs K2 at prefill and for cross attention (their
plain versions on CPU tensors) and K3 for self attention at decode; the
reference runs its flash attention kernel in interpret mode, and its
chunked scan for decode self attention.  float32 at the repository's
conformance tolerance (``atol=2e-4, rtol=1e-3``); bf16 at ``2e-2``
relative and ``2e-2`` absolute times the largest logit (at least 1):
these configs' logits reach 3-4, where one bf16 ulp of the residual
stream is 0.016-0.03, and each package's bf16 logits lie 0.02-0.05 from
its float32 ones there.  The families' on-card counterparts, which need
no JAX, are in ``tests/test_torch_attn_kernels.py``.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS
from repro.configs import smoke as jax_smoke
from repro.models import attention as jattention
from repro.models import common as jcommon
from repro.models import forward as jax_forward
from repro.models import init_caches as jax_init_caches
from repro.models import init_params as jax_init_params
from repro.serve import engine as jengine
from repro_torch.configs import ARCHS, smoke
from repro_torch.kernels.flash_attention import kernel as k2
from repro_torch.kernels.flash_decode import kernel as k3
from repro_torch.models import (attention, common, decode_step, forward,
                                init_caches, init_params, params_from_jax)
from repro_torch.serve import engine

TOL = dict(atol=2e-4, rtol=1e-3)
BF16_TOL = dict(atol=2e-2, rtol=2e-2)
B, S0, STEPS, MAX_SEQ = 3, 10, 6, 32
FAMILIES = ["mixtral-8x7b", "granite-moe-3b-a800m", "whisper-small",
            "qwen2-vl-72b"]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, tol=TOL, msg=""):
    np.testing.assert_allclose(_np(got), _np(want), err_msg=msg, **tol)


def _bf16_close(got, want, msg=""):
    """bf16 logits: ``BF16_TOL`` with the absolute part scaled by the
    largest logit."""
    scale = max(1.0, float(np.abs(_np(want)).max()))
    _close(got, want, dict(atol=BF16_TOL["atol"] * scale,
                           rtol=BF16_TOL["rtol"]), msg)


def _tree_close(got, want, tol=TOL):
    """Nested tuples of caches, leaf by leaf."""
    if isinstance(want, (tuple, list)):
        assert isinstance(got, (tuple, list)) and len(got) == len(want)
        for g, w in zip(got, want):
            _tree_close(g, w, tol)
    else:
        assert tuple(got.shape) == tuple(want.shape)
        _close(got, want, tol)


# ---------------------------------------------------------------------------
# Modules
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seq,d,offset", [(1, 8, 0), (37, 64, 0),
                                          (16, 768, 448), (5, 10, 3)])
def test_sinusoidal_positions_match_reference(seq, d, offset):
    want = jcommon.sinusoidal_positions(seq, d, offset)
    got = common.sinusoidal_positions(seq, d, offset, device="cpu")
    assert got.shape == (seq, d) and got.dtype == torch.float32
    _close(got, want)


def test_sinusoidal_at_matches_reference_and_positions():
    pos = np.array([0, 5, 447, 1535, 12], np.int32)
    want = jcommon.sinusoidal_at(jnp.asarray(pos), 64)
    got = common.sinusoidal_at(torch.from_numpy(pos), 64)
    _close(got, want)
    table = common.sinusoidal_positions(1536, 64, device="cpu")
    _close(got, table[torch.from_numpy(pos).long()])


def _cross_case(Sq, Skv, rng):
    cfg = smoke(ARCHS["whisper-small"])
    jcfg = jax_smoke(JAX_ARCHS["whisper-small"])
    d, H, KVH, D = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    p = {"wq": rng.standard_normal((d, H * D)) / np.sqrt(d),
         "wk": rng.standard_normal((d, KVH * D)) / np.sqrt(d),
         "wv": rng.standard_normal((d, KVH * D)) / np.sqrt(d),
         "wo": rng.standard_normal((H * D, d)) / np.sqrt(H * D)}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    x = rng.standard_normal((2, Sq, d)).astype(np.float32)
    enc = rng.standard_normal((2, Skv, d)).astype(np.float32)
    return cfg, jcfg, p, x, enc


@pytest.mark.parametrize("impl", ["pallas", "chunked", "reference"])
@pytest.mark.parametrize("Sq,Skv", [(1, 32), (1, 45), (7, 32), (12, 45)])
def test_cross_attention_matches_reference(Sq, Skv, impl, rng):
    """One query row (decode) and Sq < Skv (prefill), not causal; the
    reference runs its flash attention kernel in interpret mode."""
    cfg, jcfg, p, x, enc = _cross_case(Sq, Skv, rng)
    cfg, jcfg = cfg.replace(attn_impl=impl), jcfg.replace(attn_impl="pallas")
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    jkv = jattention.encode_cross_kv(jp, jnp.asarray(enc), jcfg)
    want = jattention.cross_attention(jp, jnp.asarray(x), jkv, jcfg,
                                      interpret=True)
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    kv = attention.encode_cross_kv(tp, torch.from_numpy(enc), cfg)
    _tree_close(kv, jkv)
    before = k2.launches
    got = attention.cross_attention(tp, torch.from_numpy(x), kv, cfg)
    assert k2.launches == before  # CPU tensors: the plain version
    assert got.shape == (2, Sq, cfg.d_model)
    _close(got, want)


# ---------------------------------------------------------------------------
# The families as a whole
# ---------------------------------------------------------------------------

def _configs(name, dtype="float32", impl="pallas"):
    jcfg = jax_smoke(JAX_ARCHS[name]).replace(attn_impl=impl, dtype=dtype)
    tcfg = smoke(ARCHS[name]).replace(attn_impl=impl, dtype=dtype)
    return jcfg, tcfg


@functools.lru_cache(maxsize=None)
def _jax_params(name):
    jcfg, _ = _configs(name)
    return jax_init_params(jax.random.PRNGKey(7), jcfg)


def _params(name, tcfg):
    jp = _jax_params(name)
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), tcfg,
                               device="cpu")


def _batch(cfg, S=S0, seed=0):
    """Seeded numpy tokens (B, S), and for encdec the stub frontend's
    frame embeddings (B, enc_seq, d)."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    if cfg.encdec is not None:
        batch["enc_frames"] = rng.standard_normal(
            (B, cfg.encdec.enc_seq, cfg.d_model)).astype(np.float32)
    return batch


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _tb(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.mark.parametrize("name", FAMILIES)
def test_train_logits_and_aux_match_reference(name):
    jcfg, tcfg = _configs(name)
    jp, tp = _params(name, tcfg)
    batch = _batch(tcfg)
    want = jax_forward(jp, _jb(batch), jcfg, interpret=True)
    got = forward(tp, _tb(batch), tcfg)
    assert got["logits"].shape == (B, S0, tcfg.vocab)
    _close(got["logits"], want["logits"])
    _close(got["aux"], want["aux"])
    if tcfg.family == "moe":
        assert float(got["aux"]) > 0
    else:
        assert float(got["aux"]) == 0


@pytest.mark.parametrize("name", FAMILIES)
def test_prefill_logits_and_caches_match_reference(name):
    """The prefill step's last-position logits and caches: (k, v)
    stacked over the layers, and for encdec ((k, v), (enc_k, enc_v))."""
    jcfg, tcfg = _configs(name)
    jp, tp = _params(name, tcfg)
    batch = _batch(tcfg)
    want_logits, want_caches = jengine.make_prefill_step(
        jcfg, interpret=True)(jp, _jb(batch))
    before = (k2.launches, k3.launches)
    got_logits, got_caches = engine.make_prefill_step(tcfg, device="cpu")(
        tp, _tb(batch))
    assert (k2.launches, k3.launches) == before
    assert got_logits.shape == (B, tcfg.vocab)
    _close(got_logits, want_logits)
    kv_shape = (tcfg.n_layers, B, S0, tcfg.n_kv_heads, tcfg.hd)
    if tcfg.family == "encdec":
        (k, _), (ek, _) = got_caches
        assert ek.shape == (tcfg.n_layers, B, tcfg.encdec.enc_seq,
                            tcfg.n_kv_heads, tcfg.hd)
    else:
        k, _ = got_caches
    assert k.shape == kv_shape
    _tree_close(got_caches, want_caches)


def _filled_caches(name, tcfg, jcfg, jp, batch):
    """Both packages' zeroed decode caches; for encdec the cross caches
    hold the reference prefill's encoder K/V."""
    jc = jax_init_caches(jcfg, B, MAX_SEQ, cache_dtype=jnp.float32)
    tc = init_caches(tcfg, B, MAX_SEQ, cache_dtype=torch.float32,
                     device="cpu")
    if tcfg.family == "encdec":
        _, (_, (ek, ev)) = jengine.make_prefill_step(jcfg, interpret=True)(
            jp, _jb(batch))
        jc = {**jc, "cross_k": ek, "cross_v": ev}
        tc["cross_k"].copy_(torch.from_numpy(np.array(ek)))
        tc["cross_v"].copy_(torch.from_numpy(np.array(ev)))
    return jc, tc


@pytest.mark.parametrize("name", FAMILIES)
def test_decode_steps_write_caches_in_place_as_reference(name):
    """Four decode steps: the logits agree, and the port's caches
    (written in place; encdec's cross caches read, never written) equal
    the reference's returned caches."""
    jcfg, tcfg = _configs(name)
    jp, tp = _params(name, tcfg)
    batch = _batch(tcfg)
    jc, tc = _filled_caches(name, tcfg, jcfg, jp, batch)
    views = {k: v for k, v in tc.items()}
    cross = {k: tc[k].clone() for k in ("cross_k", "cross_v") if k in tc}
    jstep = jengine.make_decode_step(jcfg, interpret=True)
    tstep = engine.make_decode_step(tcfg, device="cpu")
    jlen = jnp.zeros((B,), jnp.int32)
    tlen = torch.zeros((B,), dtype=torch.int32)
    for t in range(4):
        tok = batch["tokens"][:, t]
        jlen, tlen = jlen + 1, tlen + 1
        want, jc = jstep(jp, jnp.asarray(tok), jc, jlen)
        got = tstep(tp, torch.from_numpy(tok), tc, tlen)
        assert got.shape == (B, tcfg.vocab)
        _close(got, want, msg=f"step {t}")
    for key in ("k", "v"):
        assert tc[key] is views[key]
        _close(tc[key], jc[key])
        assert not tc[key][:, :, 4:].any()
    for key, before in cross.items():
        assert torch.equal(tc[key], before)


def _jax_step_logits(jp, jcfg, prompt, tokens):
    """The reference's decode-step logits along a fixed token path (the
    prompt, then ``tokens[:, :-1]``) from zeroed float32 caches, as its
    greedy decode runs them."""
    caches = jax_init_caches(jcfg, B, MAX_SEQ, cache_dtype=jnp.float32)
    step = jengine.make_decode_step(jcfg, interpret=True)
    lengths = jnp.zeros((B,), jnp.int32)
    feed = np.concatenate([prompt, tokens[:, :-1]], axis=1)
    out = []
    for t in range(feed.shape[1]):
        lengths = lengths + 1
        logits, caches = step(jp, jnp.asarray(feed[:, t]), caches, lengths)
        out.append(np.asarray(logits, np.float32))
    return out


@pytest.mark.parametrize("name", FAMILIES)
def test_greedy_decode_matches_reference(name):
    """The port's greedy tokens are the reference's: its decode-step
    logits along the port's token path agree at every step, and their
    argmax is the port's next token (which is how the reference's
    ``greedy_decode`` picks it)."""
    jcfg, tcfg = _configs(name)
    jp, tp = _params(name, tcfg)
    prompt = _batch(tcfg)["tokens"]
    seen = []
    got = engine.greedy_decode(tp, tcfg, torch.from_numpy(prompt), STEPS,
                               MAX_SEQ, device="cpu", on_logits=seen.append)
    assert got.dtype == torch.int32 and got.shape == (B, STEPS)
    want_logits = _jax_step_logits(jp, jcfg, prompt, got.numpy())
    assert len(seen) == len(want_logits) == S0 + STEPS - 1
    for t, (g, w) in enumerate(zip(seen, want_logits)):
        _close(g, w, msg=f"step {t}")
    want = np.stack([w.argmax(-1) for w in want_logits[S0 - 1:]], axis=1)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("name", FAMILIES)
def test_bf16_prefill_and_decode_match_reference(name):
    jcfg, tcfg = _configs(name, "bfloat16")
    jp, tp = _params(name, tcfg)
    batch = _batch(tcfg)
    want, _ = jengine.make_prefill_step(jcfg, interpret=True)(jp, _jb(batch))
    got, _ = engine.make_prefill_step(tcfg, device="cpu")(tp, _tb(batch))
    _bf16_close(got, want)
    # decode over float32 caches (the greedy default): both packages
    # store the new K/V in float32 and round them to bf16 to attend
    fixed = np.zeros((B, 2), np.int32)
    want_steps = _jax_step_logits(jp, jcfg, batch["tokens"][:, :4], fixed)
    caches = init_caches(tcfg, B, MAX_SEQ, cache_dtype=torch.float32,
                         device="cpu")
    lengths = torch.zeros((B,), dtype=torch.int32)
    feed = np.concatenate([batch["tokens"][:, :4], fixed[:, :-1]], axis=1)
    for t in range(feed.shape[1]):
        lengths = lengths + 1
        got = decode_step(tp, torch.from_numpy(feed[:, t]), caches, lengths,
                          tcfg)
        _bf16_close(got, want_steps[t], msg=f"step {t}")


def _image_then_text(rows: int, cols: int, n_text: int) -> np.ndarray:
    """M-RoPE positions (3, B, S) of a rows x cols patch image (t = 0,
    h = row, w = column) followed by text whose three components are
    equal and continue from the image's largest component plus one."""
    r, c = np.divmod(np.arange(rows * cols), cols)
    img = np.stack([np.zeros_like(r), r, c])
    start = img.max() + 1
    text = np.broadcast_to(np.arange(start, start + n_text), (3, n_text))
    pos = np.concatenate([img, text], axis=1).astype(np.int32)
    return np.ascontiguousarray(np.broadcast_to(pos[:, None],
                                                (3, B, pos.shape[1])))


def test_vlm_image_then_text_positions_match_reference():
    """qwen2-vl with a 2 x 3 patch image then 4 text tokens: the M-RoPE
    positions move the logits, and both packages agree."""
    name = "qwen2-vl-72b"
    jcfg, tcfg = _configs(name)
    jp, tp = _params(name, tcfg)
    batch = _batch(tcfg)
    batch["positions"] = _image_then_text(2, 3, S0 - 6)
    assert batch["positions"].shape == (3, B, S0)
    want = jax_forward(jp, _jb(batch), jcfg, interpret=True)["logits"]
    got = forward(tp, _tb(batch), tcfg)["logits"]
    _close(got, want)
    plain = forward(tp, {"tokens": torch.from_numpy(batch["tokens"])},
                    tcfg)["logits"]
    assert float((plain - got).abs().max()) > 1e-3
    # the default positions are the three equal components of arange(S)
    equal = np.broadcast_to(np.arange(S0, dtype=np.int32), (3, B, S0))
    same = forward(tp, {"tokens": torch.from_numpy(batch["tokens"]),
                        "positions": torch.from_numpy(equal.copy())},
                   tcfg)["logits"]
    torch.testing.assert_close(same, plain, rtol=0, atol=0)


def test_params_from_jax_splits_the_encoder_layers():
    name = "whisper-small"
    jcfg, tcfg = _configs(name)
    jp, tp = _params(name, tcfg)
    n_enc = tcfg.encdec.n_enc_layers
    assert len(tp["enc_blocks"]) == n_enc
    assert len(tp["blocks"]) == tcfg.n_layers
    w = np.asarray(jp["enc_blocks"]["attn"]["wq"])
    assert w.shape[0] == n_enc
    for i, bp in enumerate(tp["enc_blocks"]):
        np.testing.assert_array_equal(bp["attn"]["wq"].numpy(), w[i])
        np.testing.assert_array_equal(
            bp["ln1"]["bias"].numpy(),
            np.asarray(jp["enc_blocks"]["ln1"]["bias"])[i])
    cw = np.asarray(jp["blocks"]["cross_attn"]["wk"])
    for i, bp in enumerate(tp["blocks"]):
        np.testing.assert_array_equal(bp["cross_attn"]["wk"].numpy(), cw[i])
    assert set(tp["enc_norm"]) == {"scale", "bias"}
    assert set(tp["final_norm"]) == {"scale", "bias"}
    bad = jax.tree.map(np.asarray, jp)
    bad["enc_blocks"] = jax.tree.map(lambda a: a[:1], bad["enc_blocks"])
    with pytest.raises(ValueError, match="leading layer axis"):
        params_from_jax(bad, tcfg, device="cpu")


@pytest.mark.parametrize("name", FAMILIES)
def test_init_params_has_the_references_structure(name):
    jcfg, tcfg = _configs(name)
    tp = init_params(torch.Generator().manual_seed(0), tcfg, device="cpu")
    jp = jax.eval_shape(lambda: jax_init_params(jax.random.PRNGKey(0),
                                                jcfg))
    want = jax.tree.map(lambda a: a.shape, jp)

    def shapes(tree, stacked):
        if isinstance(tree, dict):
            return {k: shapes(v, stacked) for k, v in tree.items()}
        return tree.shape

    for key in want:
        if key in ("blocks", "enc_blocks"):
            layers = tp[key]
            got = shapes(layers[0], True)
            lead = jax.tree.map(lambda s: s[0], want[key],
                                is_leaf=lambda s: isinstance(s, tuple))
            assert {len(layers)} == set(jax.tree.leaves(lead))
            one = jax.tree.map(lambda s: tuple(s[1:]), want[key],
                               is_leaf=lambda s: isinstance(s, tuple))
            assert jax.tree.map(tuple, got, is_leaf=lambda s: isinstance(
                s, torch.Size)) == one
        else:
            got = jax.tree.map(tuple, shapes(tp[key], False),
                               is_leaf=lambda s: isinstance(s, torch.Size))
            assert got == want[key], key
    assert set(tp) == set(want)
