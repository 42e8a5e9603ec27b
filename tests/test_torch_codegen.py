"""The port's fused-source backend ``"torch"``
(``repro_torch.core.codegen_torch``) against the reference's emitter
(``compile_program(prog, backend="jax")``, ``repro.core.codegen_jax``):
the same seeded inputs through both, on all 15 programs, the random
stencil chains of ``tests/_progen.py`` (in 2-D and lifted to 3-D), and
the hand-written reduction shapes of ``tests/test_codegen.py``.
Tolerance: ``atol=2e-4, rtol=1e-3``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as rc
import repro_torch.core as tc
from _interp_utils import arrays_for
from _progen import _ref_str, _wsum, chain_halo, random_chain
from repro.core.programs import ALL_PROGRAMS as REF_PROGRAMS
from repro_torch.core import ALL_PROGRAMS, Generated, compile_program

TOL = dict(atol=2e-4, rtol=1e-3)


def _inputs(name, scale, seed=3):
    """Seeded inputs from the reference plan's axiom shapes (the vector
    and row dims scaled by ``scale``)."""
    kplan = rc.compile_program(REF_PROGRAMS[name](),
                               backend="interp_jax").kernel_plan
    arrs = {}
    for k, v in arrays_for(kplan, np.random.default_rng(seed)).items():
        shape = tuple(s * scale if i >= v.ndim - 2 else s
                      for i, s in enumerate(v.shape))
        a = np.random.default_rng(seed + 1).standard_normal(shape)
        arrs[k] = a.astype(np.float32)
    if name == "hydro1d":
        arrs["rho"] = arrs["rho"] ** 2 + 1.0
    return arrs


def _assert_close(got, want):
    assert set(got) == set(want)
    for k in want:
        g, w = got[k].numpy(), np.asarray(want[k])
        assert g.shape == w.shape, k
        np.testing.assert_allclose(g, w, err_msg=k, **TOL)


@pytest.mark.parametrize("scale", [1, 3])
@pytest.mark.parametrize("name", sorted(REF_PROGRAMS))
def test_emitter_matches_reference_emitter(name, scale):
    gen = compile_program(ALL_PROGRAMS[name](), backend="torch",
                          device="cpu")
    assert isinstance(gen, Generated) and gen.backend == "torch"
    assert "jax" not in gen.source and "lax" not in gen.source
    assert f"def hfav_{name}(" in gen.source
    ref = rc.compile_program(REF_PROGRAMS[name](), backend="jax")
    arrs = _inputs(name, scale)
    _assert_close(gen.fn(**arrs), ref.fn(**{k: jnp.asarray(v)
                                            for k, v in arrs.items()}))


@pytest.mark.parametrize("name", ["normalization", "smooth_norm"])
def test_auto_sends_split_schedules_to_the_emitter(name):
    gen = compile_program(ALL_PROGRAMS[name](), device="cpu")
    assert isinstance(gen, Generated)
    assert len(gen.schedule.nests) == 2
    arrs = _inputs(name, 2)
    want = tc.build_unfused(ALL_PROGRAMS[name](), device="cpu").fn(**arrs)
    _assert_close(gen.fn(**arrs), {k: v.numpy() for k, v in want.items()})


def test_emitter_runs_on_the_callers_device_and_dtype():
    prog = ALL_PROGRAMS["laplace5"]()
    u = np.random.default_rng(0).standard_normal((9, 14))
    gen = compile_program(prog, backend="torch", device="cpu",
                          dtype=torch.float64)
    out = gen.fn(cell=u)["lap"]
    assert out.dtype == torch.float64 and out.device.type == "cpu"
    # positional inputs follow the sorted input names, as in the reference
    assert torch.equal(gen.fn(u)["lap"], out)
    # an aliased input is never written in place
    t = torch.from_numpy(u.astype(np.float32))
    before = t.clone()
    compile_program(prog, backend="torch", device="cpu").fn(cell=t)
    assert torch.equal(t, before)


# ---------------------------------------------------------------------------
# Random stencil chains
# ---------------------------------------------------------------------------

def _ref3(var: str, ok: int, oj: int) -> str:
    def part(d, o):
        return f"{d}?{'+' if o > 0 else '-'}{abs(o)}" if o else f"{d}?"
    return f"{var}[{part('k', ok)}][{part('j', oj)}][i?]"


def _chain(core, desc, shape):
    """The 2-stage chain of ``desc`` built with ``core`` (``repro.core``
    or ``repro_torch.core``): as ``_progen`` builds it (``2d``), or its
    offsets lifted onto ``(k, j)`` of a ``(k, j, i)`` nest (``3d``)."""
    f1, f2 = _wsum(desc["w1"]), _wsum(desc["w2"])
    if shape == "2d":
        ref, dims, order = _ref_str, "[j?][i?]", ("j", "i")
    else:
        ref, dims, order = _ref3, "[k?][j?][i?]", ("k", "j", "i")
    k1 = core.kernel("s1", [(f"a{k}", ref("u?", a, b))
                            for k, (a, b) in enumerate(desc["offs1"])],
                     [("o", f"mid(u?{dims})")], fn=f1)
    k2 = core.kernel("s2", [(f"b{k}", f"mid({ref('u?', a, b)})")
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
                        loop_order=order, name=f"chain_{shape}")


@pytest.mark.parametrize("shape", ["2d", "3d"])
@pytest.mark.parametrize("seed", range(12))
def test_random_chains_match_reference_emitter(seed, shape):
    desc = random_chain(seed)
    u = np.random.default_rng(seed).standard_normal(
        (9, 14) if shape == "2d" else (6, 9, 11)).astype(np.float32)
    gen = compile_program(_chain(tc, desc, shape), backend="torch",
                          device="cpu", use_cache=False)
    ref = rc.compile_program(_chain(rc, desc, shape), backend="jax",
                             use_cache=False)
    _assert_close(gen.fn(u=u), ref.fn(u=jnp.asarray(u)))


# ---------------------------------------------------------------------------
# Kept-dim reductions read downstream (no unfused oracle for these)
# ---------------------------------------------------------------------------

def _rownorm(core, widen: bool, goal_rsum: bool):
    rules = [core.kernel("rs", [("x", "u[j?][i]")], [("acc", "rsum(u[j?])")],
                         fn=lambda acc, x: acc + x, kind="reduce", init=0.0)]
    if widen:
        rules.append(core.kernel(
            "df", [("a", "u?[j?][i?]"), ("s0", "rsum(u?[j?])"),
                   ("s1", "rsum(u?[j?+1])")],
            [("o", "df(u?[j?][i?])")], fn=lambda a, s0, s1: a * (s1 - s0)))
        goals = [core.goal("df(u[j][i])", store_as="df", j=("Nj", 0, 0),
                           i=("Ni", 0, 0))]
        axiom = core.axiom("u[j?][i?]", j=("Nj", 0, 1), i="Ni")
    else:
        rules.append(core.kernel(
            "nm", [("a", "u?[j?][i?]"), ("s", "rsum(u?[j?])")],
            [("o", "nm(u?[j?][i?])")], fn=lambda a, s: a / (s + 10.0)))
        goals = [core.goal("nm(u[j][i])", store_as="nm", j=("Nj", 0, 0),
                           i=("Ni", 0, 0))]
        axiom = core.axiom("u[j?][i?]", j="Nj", i="Ni")
    if goal_rsum:
        goals.append(core.goal("rsum(u[j])", store_as="rsum",
                               j=("Nj", 0, 0)))
    return core.Program(rules=rules, axioms=[axiom], goals=goals,
                        loop_order=("j", "i"), name="rownorm")


@pytest.mark.parametrize("widen,goal_rsum", [(False, False), (False, True),
                                             (True, True)])
def test_kept_reductions_read_downstream(widen, goal_rsum):
    """A row-kept reduction consumed by a later kernel (one accumulator
    cell per row position), also stored as a goal, and widened above
    the goal by a ``j+1`` read (the returned goal is re-seated)."""
    u = np.random.default_rng(0).standard_normal(
        (7 if widen else 6, 9)).astype(np.float32)
    gen = compile_program(_rownorm(tc, widen, goal_rsum), backend="torch",
                          device="cpu", use_cache=False)
    ref = rc.compile_program(_rownorm(rc, widen, goal_rsum), backend="jax",
                             use_cache=False)
    got = gen.fn(u)
    _assert_close(got, ref.fn(jnp.asarray(u)))
    rs = u.sum(1)
    if widen:
        assert tuple(got["rsum"].shape) == (6,)
        np.testing.assert_allclose(got["df"].numpy(),
                                   u[:6] * (rs[1:7] - rs[:6])[:, None], **TOL)
    else:
        np.testing.assert_allclose(got["nm"].numpy(),
                                   u / (rs[:, None] + 10.0), **TOL)
