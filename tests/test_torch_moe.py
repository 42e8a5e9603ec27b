"""The port's mixture of experts (``repro_torch.models.moe``) against the
JAX package's ``repro.models.moe``.

The same seeded numpy parameters and activations go through both
``moe_ffn``s in float32 at the repository's conformance tolerance
(``atol=2e-4, rtol=1e-3``): random routers, a zero router (every expert
ties, so both take experts ``0 .. K-1`` and drop by capacity in token
order), and a capacity small enough to drop most tokens.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS
from repro.configs import smoke as jax_smoke
from repro.models import moe as jmoe
from repro_torch.configs import ARCHS, MoECfg, smoke
from repro_torch.models import moe

TOL = dict(atol=2e-4, rtol=1e-3)
BF16_TOL = dict(atol=2e-2, rtol=2e-2)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x, np.float32)


def _cfgs(name="granite-moe-3b-a800m", **moe_kw):
    jcfg, tcfg = jax_smoke(JAX_ARCHS[name]), smoke(ARCHS[name])
    if moe_kw:
        m = MoECfg(**{**tcfg.moe.__dict__, **moe_kw})
        jcfg, tcfg = jcfg.replace(moe=type(jcfg.moe)(**m.__dict__)), \
            tcfg.replace(moe=m)
    return jcfg, tcfg


def _params(cfg, seed, router_scale=1.0):
    rng = np.random.default_rng(seed)
    m, d = cfg.moe, cfg.d_model
    E, f = m.n_experts, m.d_ff_expert
    return {
        "router": rng.standard_normal((d, E)).astype(np.float32)
        * router_scale / np.sqrt(d),
        "w_gate": rng.standard_normal((E, d, f)).astype(np.float32)
        / np.sqrt(d),
        "w_up": rng.standard_normal((E, d, f)).astype(np.float32)
        / np.sqrt(d),
        "w_down": rng.standard_normal((E, f, d)).astype(np.float32)
        / np.sqrt(f),
    }


def _both(p, x, jcfg, tcfg, dtype="float32"):
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want, want_aux = jmoe.moe_ffn({k: jnp.asarray(v) for k, v in p.items()},
                                  jnp.asarray(x, jd), jcfg)
    got, got_aux = moe.moe_ffn({k: torch.from_numpy(v) for k, v in p.items()},
                               torch.from_numpy(x).to(td), tcfg)
    assert got.dtype == td and got_aux.dtype == torch.float32
    return (got, got_aux), (want, want_aux)


@pytest.mark.parametrize("name", ["granite-moe-3b-a800m", "mixtral-8x7b"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_moe_ffn_matches_reference(name, seed):
    jcfg, tcfg = _cfgs(name)
    p = _params(tcfg, seed)
    x = np.random.default_rng(seed + 10).standard_normal(
        (3, 17, tcfg.d_model)).astype(np.float32)
    (got, got_aux), (want, want_aux) = _both(p, x, jcfg, tcfg)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)
    np.testing.assert_allclose(float(got_aux), float(want_aux), **TOL)


def test_moe_ffn_zero_router_ties_to_the_lower_experts():
    """A zero router: all E probabilities tie.  Both packages take experts
    0 .. K-1 for every token, so experts 0 and 1 fill to capacity in
    token order and drop the rest; the other experts see nothing."""
    jcfg, tcfg = _cfgs()
    p = _params(tcfg, 3)
    p["router"][:] = 0
    x = np.random.default_rng(4).standard_normal(
        (2, 40, tcfg.d_model)).astype(np.float32)
    _, _, gate_i = moe.route({"router": torch.from_numpy(p["router"])},
                             torch.from_numpy(x), tcfg)
    K = tcfg.moe.top_k
    assert (gate_i == torch.arange(K)).all()
    (got, got_aux), (want, want_aux) = _both(p, x, jcfg, tcfg)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)
    np.testing.assert_allclose(float(got_aux), float(want_aux), **TOL)
    # capacity 25 of 40 tokens: the last 15 tokens of each sequence drop
    C = moe.capacity(40, tcfg)
    assert C < 40
    assert not got[:, C:].any() and got[:, :C].abs().sum(-1).gt(0).all()


def test_moe_ffn_drops_tokens_past_a_small_capacity():
    jcfg, tcfg = _cfgs(capacity_factor=0.25)
    p = _params(tcfg, 5, router_scale=4.0)
    x = np.random.default_rng(6).standard_normal(
        (2, 64, tcfg.d_model)).astype(np.float32)
    C = moe.capacity(64, tcfg)
    _, _, gate_i = moe.route({"router": torch.from_numpy(p["router"])},
                             torch.from_numpy(x), tcfg)
    per_expert = torch.stack([torch.bincount(g.reshape(-1),
                                             minlength=tcfg.moe.n_experts)
                              for g in gate_i])
    assert (per_expert > C).any()  # some (token, slot) pairs drop
    (got, got_aux), (want, want_aux) = _both(p, x, jcfg, tcfg)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)
    np.testing.assert_allclose(float(got_aux), float(want_aux), **TOL)


def test_moe_ffn_bf16_matches_reference():
    jcfg, tcfg = _cfgs()
    p = _params(tcfg, 8)
    x = np.random.default_rng(9).standard_normal(
        (2, 9, tcfg.d_model)).astype(np.float32)
    (got, got_aux), (want, want_aux) = _both(p, x, jcfg, tcfg, "bfloat16")
    np.testing.assert_allclose(_np(got), _np(want), **BF16_TOL)
    np.testing.assert_allclose(float(got_aux), float(want_aux), **BF16_TOL)


@pytest.mark.parametrize("name", ["granite-moe-3b-a800m", "mixtral-8x7b"])
@pytest.mark.parametrize("full", [False, True])
def test_capacity_matches_reference(name, full):
    jcfg, tcfg = JAX_ARCHS[name], ARCHS[name]
    if not full:
        jcfg, tcfg = jax_smoke(jcfg), smoke(tcfg)
    for S in (1, 2, 3, 7, 16, 31, 64, 100, 448, 2048, 4096):
        assert moe.capacity(S, tcfg) == jmoe.capacity(S, jcfg), S


def test_moe_init_shapes():
    _, tcfg = _cfgs()
    p = moe.moe_init(torch.Generator().manual_seed(0), tcfg, device="cpu")
    m, d = tcfg.moe, tcfg.d_model
    assert p["router"].shape == (d, m.n_experts)
    assert p["w_gate"].shape == p["w_up"].shape == (m.n_experts, d,
                                                    m.d_ff_expert)
    assert p["w_down"].shape == (m.n_experts, m.d_ff_expert, d)
    assert all(t.dtype == torch.float32 for t in p.values())
