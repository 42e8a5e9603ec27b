"""The port's half of the random-chain differential tests.

Each ``random_chain(seed)`` descriptor of ``tests/_progen.py`` (imported
read-only) is built twice, with the JAX package's ``repro.core`` and with
the port's ``repro_torch.core``, in two shapes:

* ``2d``: the chain as ``_progen`` builds it, loop order ``(j, i)``;
* ``3d``: the same offsets lifted onto ``(k, j)`` of a ``(k, j, i)``
  nest, so the chain's reads become plane windows (an input plane window
  and, for the second stage, a producer plane window with a row halo),
  the shape of heat3d and heat3d_stage.  The planner refuses some of
  these (stencil offsets of a produced variable in the outer dim); both
  packages must then refuse.

Three legs per chain, each shrunk with ``shrink_chain`` on failure to a
minimal failing descriptor:

* the port's plan against the reference's ``plan_pallas``, through
  ``from_reference_dict``;
* ``interp_torch`` against the reference's ``interp_jax`` and the port's
  ``unfused`` (the reference's Pallas interpreter cannot run with the
  installed jax, ROADMAP);
* the stencil kernel K1 compiled as host C++ (``-DHFAV_EMULATE``, the
  emulated ``"cuda"`` interpreter of ``tests/_emulate.py``) with small
  forced row chunks and plane chunks, against ``interp_torch``;

and the barriers of each chain's emitted row step against the hazard
analysis of ``tests/_emulate.py`` (``check_barriers``).

Tolerance: the repository's conformance tolerance, ``atol=2e-4,
rtol=1e-3`` (``tests/test_interp_conformance.py``).
"""
from __future__ import annotations

import contextlib
import json

import jax.numpy as jnp
import numpy as np
import pytest

import repro.core as rc
import repro_torch.core as tc
from _emulate import check_barriers
from _emulate import emulator  # noqa: F401 (the emulated K1)
from _progen import _ref_str, _wsum, chain_halo, random_chain, shrink_chain
from repro.core.plan import register_step_builder as ref_register
from repro.core.plan import unregister_step_builder as ref_unregister
from repro_torch.core.plan import (register_step_builder,
                                   unregister_step_builder)

TOL = dict(atol=2e-4, rtol=1e-3)
SEEDS = range(12)
SHAPES = {"2d": (9, 14), "3d": (6, 9, 11)}


def _ref3(var: str, ok: int, oj: int) -> str:
    def part(d, o):
        return f"{d}?{'+' if o > 0 else '-'}{abs(o)}" if o else f"{d}?"
    return f"{var}[{part('k', ok)}][{part('j', oj)}][i?]"


def _program(core, desc: dict, shape: str, name: str):
    """The chain program of ``desc`` built with ``core`` (``repro.core``
    or ``repro_torch.core``), its two bodies registered as step builders
    under keys both packages share."""
    f1, f2 = _wsum(desc["w1"]), _wsum(desc["w2"])
    register = ref_register if core is rc else register_step_builder
    register(f"progen:{name}:s1", f1)
    register(f"progen:{name}:s2", f2)
    if shape == "2d":
        ref, dims, order = _ref_str, "[j?][i?]", ("j", "i")
    else:
        ref, dims, order = _ref3, "[k?][j?][i?]", ("k", "j", "i")
    k1 = core.kernel(
        "s1", [(f"a{k}", ref("u?", a, b))
               for k, (a, b) in enumerate(desc["offs1"])],
        [("o", f"mid(u?{dims})")], fn=f1)
    k2 = core.kernel(
        "s2", [(f"b{k}", f"mid({ref('u?', a, b)})")
               for k, (a, b) in enumerate(desc["offs2"])],
        [("o", f"out(u?{dims})")], fn=f2)
    ha, hb = chain_halo(desc)
    if shape == "2d":
        ext = dict(j=("Nj", ha, -ha), i=("Ni", hb, -hb))
        ax = core.axiom("u[j?][i?]", j="Nj", i="Ni")
        term = "out(u[j][i])"
    else:
        ext = dict(k=("Nk", ha, -ha), j=("Nj", hb, -hb), i=("Ni", 0, 0))
        ax = core.axiom("u[k?][j?][i?]", k="Nk", j="Nj", i="Ni")
        term = "out(u[k][j][i])"
    return core.Program(rules=[k1, k2], axioms=[ax],
                        goals=[core.goal(term, store_as="out", **ext)],
                        loop_order=order, name=name)


@contextlib.contextmanager
def _chain(core, desc, shape):
    """The chain program built with ``core``, its step builders
    registered for the duration."""
    name = f"chain_{shape}_{desc['seed']}"
    try:
        yield _program(core, desc, shape, name)
    finally:
        for key in (f"progen:{name}:s1", f"progen:{name}:s2"):
            (ref_unregister if core is rc else unregister_step_builder)(key)


def _compiled(core, desc, shape, backend, **options):
    """``(compiled, None)``, or ``(None, error)`` where the planner
    refuses the chain."""
    kw = {"device": "cpu"} if core is tc else {}
    with _chain(core, desc, shape) as prog:
        try:
            return core.compile_program(prog, backend=backend,
                                        use_cache=False, **kw,
                                        **options), None
        except (rc.PallasUnsupported, tc.PallasUnsupported) as e:
            return None, e


def _input(desc, shape):
    rng = np.random.default_rng(desc["seed"])
    return rng.standard_normal(SHAPES[shape]).astype(np.float32)


def _plan_leg(desc, shape, emu) -> str:
    ref, ref_err = _compiled(rc, desc, shape, "interp_jax")
    port, port_err = _compiled(tc, desc, shape, "interp_torch")
    if (ref is None) != (port is None):
        return f"refusal differs: reference {ref_err!r}, port {port_err!r}"
    if ref is None:
        return ""
    # the reference's plan serializes its bodies as registered specs,
    # which re-link onto the port's registrations of the same keys
    with _chain(rc, desc, shape) as prog, _chain(tc, desc, shape):
        ref_dict = rc.compile_program(prog, backend="interp_jax",
                                      use_cache=False).kernel_plan.to_dict()
        linked = tc.from_reference_dict(ref_dict)
    if linked != port.kernel_plan:
        return "plan-vs-plan_pallas"
    return ""


def _interp_leg(desc, shape, emu) -> str:
    port, err = _compiled(tc, desc, shape, "interp_torch")
    if port is None:
        return ""
    u = _input(desc, shape)
    got = port.fn(u=u)["out"].numpy()
    jx, _ = _compiled(rc, desc, shape, "interp_jax")
    want = np.asarray(jx.fn(u=jnp.asarray(u))["out"])
    if got.shape != want.shape or not np.allclose(got, want, **TOL):
        return "interp_torch-vs-interp_jax"
    with _chain(tc, desc, shape) as prog:
        unf = tc.build_unfused(prog, device="cpu").fn(u=u)["out"].numpy()
    if not np.allclose(got, unf, **TOL):
        return "interp_torch-vs-unfused"
    return ""


def _kernel_leg(desc, shape, emu) -> str:
    port, err = _compiled(tc, desc, shape, "interp_torch")
    if port is None:
        return ""
    u = _input(desc, shape)
    want = port.fn(u=u)["out"].numpy()
    for chunk, plane_chunk in ((1, 1), (2, 3), (None, None)):
        opts = {"chunk": chunk}
        if shape == "3d":
            opts["plane_chunk"] = plane_chunk
        gen, _ = _compiled(tc, desc, shape, emu, **opts)
        got = gen.fn(u=u)["out"].numpy()
        if not np.allclose(got, want, **TOL):
            return f"emulated-K1-vs-interp_torch (chunks {opts})"
    return ""


def _check(leg, desc, shape, emu) -> None:
    tag = leg(desc, shape, emu)
    if not tag:
        return
    minimal = shrink_chain(desc, lambda d: bool(leg(d, shape, emu)))
    pytest.fail(f"{shape} chain: {leg(minimal, shape, emu)}; minimal "
                f"failing chain:\n{json.dumps(minimal, indent=1)}")


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("seed", SEEDS)
def test_chain_plan_matches_reference_planner(seed, shape):
    _check(_plan_leg, random_chain(seed), shape, None)


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("seed", SEEDS)
def test_chain_interp_torch_matches_interp_jax_and_unfused(seed, shape):
    _check(_interp_leg, random_chain(seed), shape, None)


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("seed", SEEDS)
def test_chain_emulated_kernel_matches_interp_torch(seed, shape, emulator):
    _check(_kernel_leg, random_chain(seed), shape, emulator)


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("seed", SEEDS)
def test_chain_row_step_barriers_cover_every_hazard(seed, shape):
    gen, _ = _compiled(tc, random_chain(seed), shape, "interp_torch")
    for call in gen.kernel_plan.calls if gen is not None else ():
        if call.has_grid:
            check_barriers(call)


def test_some_3d_chains_have_plane_windows_and_row_halos():
    """The 3-D lifting reaches the plane-window paths it is there for."""
    from repro_torch.kernels.stencil2d.emit import CallLayout

    layouts = []
    for seed in SEEDS:
        gen, _ = _compiled(tc, random_chain(seed), "3d", "interp_torch")
        if gen is not None:
            layouts += [CallLayout(c) for c in gen.kernel_plan.calls
                        if c.has_grid]
    assert sum(lay.planar for lay in layouts) >= 6
    assert any(lay.plane_wins and lay.prime > 0 for lay in layouts)
