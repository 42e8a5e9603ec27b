"""The port's trainer against the JAX package's.

Each family at the reference's smoke width in float32 (dense
qwen3-0.6b, moe granite-moe-3b-a800m, ssm mamba2-130m, hybrid
zamba2-2.7b, encdec whisper-small, vlm qwen2-vl-72b), parameters from
``PRNGKey(3)`` moved across with ``params_from_jax``, the same seeded
numpy batch through both packages:

* ``loss_fn`` and its gradients against ``jax.value_and_grad`` of
  ``repro.train.step.loss_fn`` (gradients back through
  ``params_to_jax``), on the smoke default route and, where the
  reference's gradients are finite, on the trained one (``"chunked"``
  attention, ``remat="full"``): loss ``rtol=1e-5``, gradients ``atol=1e-5,
  rtol=1e-4`` with the absolute part times the leaf's largest value (at
  least 1).  The hybrid family's gradients reach 70-130 (``embed``) and
  their float32 rounding is amplified by the random Mamba2 stack: two
  exact float32 routes inside the port (``attn_impl="reference"`` and
  ``"chunked"``) differ by up to 3.9e-5 of the leaf's largest value
  over seeds 1-3, against 1e-6 or less in the other families, so its
  absolute part is ``1e-4`` (scaled the same way);
* one ``make_train_step`` step against the reference's, after two
  reference steps carried across with ``opt_state_from_jax``: params,
  ``m``, ``v``, ``lr`` and ``grad_norm``;
* microbatches (2 against 1, the vlm family's ``(3, B, S)`` positions
  split on axis 1), ``remat`` ``"full"``/``"dots"``/``"none"``, and
  ``compress_grads("bf16")`` bit for bit;
* the chunked SSD scan's gradients are finite (the reference's are
  NaN: ``where`` after an ``exp`` that overflows above the diagonal)
  and equal the per-token recurrence's;
* the forward-only kernels: the reference cannot differentiate its
  flash attention kernel, and the port's K2, K3 and K4 raise under
  grad (their on-card route is in ``tests/test_torch_attn_kernels.py``).
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
from repro.kernels.flash_attention.kernel import \
    flash_attention_fwd as jax_flash_attention
from repro.models import init_params as jax_init_params
from repro.optim.adamw import AdamWCfg as JaxAdamWCfg
from repro.optim.adamw import compress_grads as jax_compress_grads
from repro.optim.adamw import init_opt_state as jax_init_opt_state
from repro.train.step import loss_fn as jax_loss_fn
from repro.train.step import make_train_step as jax_make_train_step
from repro_torch.configs import ARCHS, smoke
from repro_torch.kernels.flash_attention.kernel import flash_attention_fwd
from repro_torch.kernels.flash_decode.kernel import flash_decode
from repro_torch.kernels.ssd.kernel import ssd_kernel
from repro_torch.models import (init_params, opt_state_from_jax,
                                params_from_jax, params_to_jax)
from repro_torch.optim.adamw import AdamWCfg, compress_grads, global_norm
from repro_torch.tree import tree_leaves
from repro_torch.train.step import make_train_step, value_and_grad

FAMILIES = {"dense": "qwen3-0.6b", "moe": "granite-moe-3b-a800m",
            "ssm": "mamba2-130m", "hybrid": "zamba2-2.7b",
            "encdec": "whisper-small", "vlm": "qwen2-vl-72b"}
LOSS_TOL = dict(rtol=1e-5)
GRAD_TOL = dict(atol=1e-5, rtol=1e-4)
HYBRID_GRAD_TOL = dict(atol=1e-4, rtol=1e-4)
B, S = 2, 16


def _configs(arch: str):
    return jax_smoke(JAX_ARCHS[arch]), smoke(ARCHS[arch])


def _batch(cfg, seed: int = 0, positions: bool = False) -> dict:
    """Tokens and next-token targets (and whisper's stub frames, and
    M-RoPE positions of three different components when asked)."""
    rng = np.random.default_rng(seed)
    seq = rng.integers(0, cfg.vocab, (B, S + 1)).astype(np.int32)
    batch = {"tokens": seq[:, :-1].copy(), "targets": seq[:, 1:].copy()}
    if cfg.family == "encdec":
        batch["enc_frames"] = rng.standard_normal(
            (B, cfg.encdec.enc_seq, cfg.d_model)).astype(np.float32)
    if positions:
        base = np.arange(S, dtype=np.int32)
        batch["positions"] = np.stack([
            np.broadcast_to(base + 3 * c + b, (S,))
            for c in range(3) for b in range(B)]).reshape(3, B, S)
    return batch


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in batch.items()}


def _jax_params(jcfg):
    return jax_init_params(jax.random.PRNGKey(3), jcfg)


def _numpy_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _tree_close(got, want, tol, what, scaled: bool = False):
    """Two reference-layout pytrees of numpy arrays, leaf by leaf; with
    ``scaled`` the absolute tolerance is times the leaf's largest value
    (at least 1)."""
    flat_w, tdef = jax.tree_util.tree_flatten_with_path(want)
    flat_g = tdef.flatten_up_to(got)
    for (path, w), g in zip(flat_w, flat_g):
        w = np.asarray(w)
        scale = max(1.0, float(np.abs(w).max())) if scaled else 1.0
        np.testing.assert_allclose(
            np.asarray(g), w, atol=tol["atol"] * scale, rtol=tol["rtol"],
            err_msg=f"{what} {jax.tree_util.keystr(path)}")


# (family, route): every family on the smoke default (``"reference"``
# attention and SSD, no remat), and the families whose reference
# gradients are finite on the trained route too (``"chunked"``, two
# attention chunks, ``remat="full"``); the reference's chunked SSD scan
# gives NaN gradients (``test_chunked_ssd_gradients_are_finite``)
ROUTES = [(f, "reference") for f in sorted(FAMILIES)] + \
    [(f, "chunked") for f in ("dense", "encdec", "moe", "vlm")]
TRAINED_ROUTE = dict(attn_impl="chunked", attn_chunk=S // 2, remat="full")


@pytest.mark.parametrize("family,route", ROUTES)
def test_loss_and_grads_match_reference(family, route):
    jcfg, cfg = _configs(FAMILIES[family])
    if route == "chunked":
        jcfg, cfg = jcfg.replace(**TRAINED_ROUTE), cfg.replace(**TRAINED_ROUTE)
    jp = _jax_params(jcfg)
    batch = _batch(cfg, seed=1)
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        functools.partial(jax_loss_fn, cfg=jcfg), has_aux=True))(
            jp, _jax(batch))
    params = params_from_jax(_numpy_tree(jp), cfg, "cpu")
    (loss, metrics), grads = value_and_grad(params, _torch(batch), cfg)
    np.testing.assert_allclose(float(loss), float(jl), **LOSS_TOL)
    np.testing.assert_allclose(float(metrics["aux"]), float(jm["aux"]),
                               rtol=1e-5, atol=1e-7)
    _tree_close(params_to_jax(grads, cfg), _numpy_tree(jg),
                HYBRID_GRAD_TOL if family == "hybrid" else GRAD_TOL,
                f"{family} grad", scaled=True)
    # every parameter of the smoke models reaches the loss
    assert all(float(g.abs().max()) > 0 for g in tree_leaves(grads))


@pytest.mark.parametrize("family", ["dense", "ssm"])
def test_one_step_matches_reference_after_two(family):
    """Two reference steps, the state carried across, then one step in
    each package: params, m, v, lr and grad_norm."""
    jcfg, cfg = _configs(FAMILIES[family])
    kw = dict(lr=1e-3, warmup_steps=2, total_steps=10)
    jstep = jax.jit(jax_make_train_step(jcfg, JaxAdamWCfg(**kw)))
    jp = _jax_params(jcfg)
    jopt = jax_init_opt_state(jp)
    for s in range(2):
        jp, jopt, _ = jstep(jp, jopt, _jax(_batch(cfg, seed=10 + s)))
    params = params_from_jax(_numpy_tree(jp), cfg, "cpu")
    opt = opt_state_from_jax(_numpy_tree(jopt), cfg, "cpu")
    assert int(opt["step"]) == 2
    batch = _batch(cfg, seed=12)
    jp2, jopt2, jmet = jstep(jp, jopt, _jax(batch))
    p2, opt2, met = make_train_step(cfg, AdamWCfg(**kw))(params, opt,
                                                         _torch(batch))
    np.testing.assert_allclose(float(met["loss"]), float(jmet["loss"]),
                               **LOSS_TOL)
    np.testing.assert_allclose(float(met["lr"]), float(jmet["lr"]),
                               rtol=1e-6)
    np.testing.assert_allclose(float(met["grad_norm"]),
                               float(jmet["grad_norm"]), rtol=1e-4)
    assert int(opt2["step"]) == int(jopt2["step"]) == 3
    _tree_close(params_to_jax(p2, cfg), _numpy_tree(jp2),
                dict(atol=2e-6, rtol=1e-5), f"{family} params")
    _tree_close(params_to_jax(opt2["m"], cfg), _numpy_tree(jopt2["m"]),
                GRAD_TOL, f"{family} m")
    _tree_close(params_to_jax(opt2["v"], cfg), _numpy_tree(jopt2["v"]),
                dict(atol=1e-9, rtol=2e-4), f"{family} v")
    # the step is functional: the caller's tensors are unchanged
    np.testing.assert_array_equal(params["embed"].numpy(),
                                  np.asarray(jp["embed"]))


@pytest.mark.parametrize("arch,positions", [("minitron-4b", False),
                                            ("qwen2-vl-72b", True)])
def test_microbatches_match_one_batch(arch, positions):
    """``microbatches=2`` against 1, as the reference's
    ``test_microbatch_grad_equivalence`` (its tolerances); the vlm case
    passes M-RoPE positions (3, B, S) whose batch rows differ, so a
    split on the wrong axis shows, and is also held against the
    reference's two-microbatch step."""
    jcfg, cfg = _configs(arch)
    jp = _jax_params(jcfg)
    batch = _batch(cfg, seed=4, positions=positions)
    ocfg = AdamWCfg(lr=1e-3, warmup_steps=1, total_steps=10)
    params = params_from_jax(_numpy_tree(jp), cfg, "cpu")
    opt = opt_state_from_jax(_numpy_tree(jax_init_opt_state(jp)), cfg, "cpu")
    p1, _, m1 = make_train_step(cfg, ocfg)(params, opt, _torch(batch))
    p2, _, m2 = make_train_step(cfg, ocfg, microbatches=2)(params, opt,
                                                           _torch(batch))
    np.testing.assert_allclose(float(m1["loss"]), float(m2["loss"]),
                               rtol=1e-5)
    for a, b in zip(tree_leaves(p1), tree_leaves(p2)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=2e-5,
                                   rtol=1e-4)
    if positions:
        # against the reference's two-microbatch step, after a reference
        # step carried across (a first AdamW step moves every parameter
        # by about lr whatever its gradient, so a gradient near zero
        # flips it: compare where v is warm)
        jocfg = JaxAdamWCfg(lr=1e-3, warmup_steps=1, total_steps=10)
        jp, jopt, _ = jax.jit(jax_make_train_step(jcfg, jocfg))(
            jp, jax_init_opt_state(jp), _jax(_batch(cfg, seed=5)))
        jp2, jopt2, jm2 = jax.jit(jax_make_train_step(
            jcfg, jocfg, microbatches=2))(jp, jopt, _jax(batch))
        p2, opt2, m2 = make_train_step(cfg, ocfg, microbatches=2)(
            params_from_jax(_numpy_tree(jp), cfg, "cpu"),
            opt_state_from_jax(_numpy_tree(jopt), cfg, "cpu"), _torch(batch))
        np.testing.assert_allclose(float(m2["loss"]), float(jm2["loss"]),
                                   **LOSS_TOL)
        _tree_close(params_to_jax(p2, cfg), _numpy_tree(jp2),
                    dict(atol=2e-6, rtol=1e-5), "vlm microbatch params")
        _tree_close(params_to_jax(opt2["m"], cfg), _numpy_tree(jopt2["m"]),
                    GRAD_TOL, "vlm microbatch m")


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_remat_modes_give_the_same_grads(family):
    _, cfg = _configs(FAMILIES[family])
    gen = torch.Generator().manual_seed(5)
    params = init_params(gen, cfg, device="cpu")
    batch = _torch(_batch(cfg, seed=6))
    got = {}
    for mode in ("none", "full", "dots"):
        (loss, _), grads = value_and_grad(params, batch,
                                          cfg.replace(remat=mode))
        got[mode] = (float(loss), tree_leaves(grads))
    for mode in ("full", "dots"):
        assert got[mode][0] == pytest.approx(got["none"][0], abs=1e-6)
        for a, b in zip(got[mode][1], got["none"][1]):
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6,
                                       rtol=1e-6)


def test_remat_rejects_unknown_mode():
    _, cfg = _configs("qwen3-0.6b")
    params = init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    with pytest.raises(ValueError, match="remat"):
        value_and_grad(params, _torch(_batch(cfg)), cfg.replace(remat="all"))


@pytest.mark.parametrize("family", ["ssm", "hybrid"])
def test_chunked_ssd_gradients_are_finite(family):
    """Training's SSD route (``"chunked"``, the configs' default) gives
    the per-token recurrence's gradients; the reference's chunked scan
    gives NaN on the same call (shown on the ssm family)."""
    jcfg, cfg = _configs(FAMILIES[family])
    jp = _jax_params(jcfg)
    batch = _batch(cfg, seed=1)
    if family == "ssm":
        (_, _), jg = jax.jit(jax.value_and_grad(
            functools.partial(jax_loss_fn,
                              cfg=jcfg.replace(attn_impl="chunked")),
            has_aux=True))(jp, _jax(batch))
        assert not all(np.isfinite(np.asarray(g)).all()
                       for g in jax.tree.leaves(jg))
    params = params_from_jax(_numpy_tree(jp), cfg, "cpu")
    (_, _), want = value_and_grad(params, _torch(batch), cfg)
    (_, _), got = value_and_grad(params, _torch(batch),
                                 cfg.replace(attn_impl="chunked"))
    _tree_close(params_to_jax(got, cfg), params_to_jax(want, cfg),
                HYBRID_GRAD_TOL if family == "hybrid" else GRAD_TOL,
                f"{family} chunked grad", scaled=True)


def test_ssm_gradient_norm_grows_with_depth_as_in_reference():
    """mamba2-130m's stack at full width (d_model 768; the vocabulary
    cut to 512), float32, from the reference's weights: the port's
    trained route (``"chunked"``) gives the reference's gradient norm
    (its per-token route: its chunked scan's gradients are NaN) at 2 and
    at 8 layers, and in both packages the norm grows more than tenfold
    between them.  This is the exploding gradient that keeps the
    full-depth model's loss flat over ``chip_smoke.py``'s 10 training
    steps.  ``rtol=5e-3``: a 1e-7 relative change of the weights moves
    the 8-layer gradient by about 1e-3 of itself, so the two packages'
    float32 rounding does too."""
    kw = dict(n_layers=8, vocab=512, dtype="float32", remat="none")
    jcfg = JAX_ARCHS["mamba2-130m"].replace(attn_impl="reference", **kw)
    cfg = ARCHS["mamba2-130m"].replace(attn_impl="chunked", **kw)
    jp = _jax_params(jcfg)
    seq = np.random.default_rng(0).integers(0, cfg.vocab, (1, 65))
    batch = {"tokens": seq[:, :-1].astype(np.int32),
             "targets": seq[:, 1:].astype(np.int32)}
    norms = []
    for layers in (2, 8):
        jpl = dict(jp, blocks=jax.tree.map(lambda a: a[:layers],
                                           jp["blocks"]))
        jcl, cl = jcfg.replace(n_layers=layers), cfg.replace(n_layers=layers)
        (_, _), jg = jax.jit(jax.value_and_grad(
            functools.partial(jax_loss_fn, cfg=jcl), has_aux=True))(
                jpl, _jax(batch))
        params = params_from_jax(_numpy_tree(jpl), cl, "cpu")
        (_, _), grads = value_and_grad(params, _torch(batch), cl)
        want = float(np.sqrt(sum(np.sum(np.square(np.asarray(g)))
                                 for g in jax.tree.leaves(jg))))
        got = float(global_norm(grads))
        np.testing.assert_allclose(got, want, rtol=5e-3)
        norms.append((got, want))
    assert norms[1][0] > 10 * norms[0][0] and norms[1][1] > 10 * norms[0][1]


def test_compress_grads_bf16_matches_reference():
    rng = np.random.default_rng(0)
    g = rng.standard_normal((64, 64)).astype(np.float32) * 3
    want = np.asarray(jax_compress_grads({"w": jnp.asarray(g)}, "bf16")["w"])
    got = compress_grads({"w": torch.from_numpy(g)}, "bf16")["w"]
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    assert compress_grads({"w": torch.from_numpy(g)}, "none")["w"] is not None
    with pytest.raises(ValueError, match="grad_compression"):
        compress_grads({"w": torch.from_numpy(g)}, "fp8")


def test_reference_cannot_differentiate_its_flash_attention():
    """The reference has no backward for its kernel: ``jax.grad``
    through ``flash_attention_fwd`` fails, so the port's K2 refusing
    grad matches it (the port trained through the kernels' plain
    versions on the CPU before)."""
    q = jnp.asarray(np.random.default_rng(0).standard_normal(
        (1, 16, 2, 16)), jnp.float32)
    with pytest.raises(AssertionError):
        jax.grad(lambda q: jax_flash_attention(q, q, q, causal=True,
                                               interpret=True).sum())(q)


def _grad_inputs():
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.standard_normal((1, 16, 2, 16)).astype(
        np.float32)).requires_grad_()
    cache = torch.from_numpy(rng.standard_normal((1, 16, 2, 16)).astype(
        np.float32))
    x = torch.from_numpy(rng.standard_normal((1, 16, 2, 8)).astype(
        np.float32)).requires_grad_()
    bm = torch.from_numpy(rng.standard_normal((1, 16, 4)).astype(np.float32))
    return q, cache, x, bm


@pytest.mark.parametrize("kernel", ["K2", "K3", "K4"])
def test_forward_only_kernels_refuse_grad(kernel):
    q, cache, x, bm = _grad_inputs()
    lengths = torch.full((1,), 9, dtype=torch.int32)
    dt = torch.full((1, 16, 2), 0.1)
    A, D = -torch.ones(2), torch.ones(2)
    calls = {"K2": lambda: flash_attention_fwd(q, cache, cache, causal=True),
             "K3": lambda: flash_decode(q[:, 0], cache, cache, lengths),
             "K4": lambda: ssd_kernel(x, dt, A, bm, bm, D, chunk=8)}
    with pytest.raises(RuntimeError, match='attn_impl="chunked"'):
        calls[kernel]()
    with torch.no_grad():  # serving: the same call runs
        assert torch.isfinite(calls[kernel]()).all()


def test_train_step_through_pallas_route_raises():
    _, cfg = _configs("qwen3-0.6b")
    params = init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    step = make_train_step(cfg.replace(attn_impl="pallas"), AdamWCfg())
    with pytest.raises(RuntimeError, match="forward-only"):
        step(params, {"m": params, "v": params, "step": torch.zeros(
            (), dtype=torch.int32)}, _torch(_batch(cfg)))
