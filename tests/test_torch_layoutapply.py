"""LayoutApply in the port (``repro_torch.core.layoutapply``) and the
layout half of ``interp_torch``, held against the reference's
``repro.core.layoutapply`` and ``interp_jax``:

* the port's ``apply_layout`` on each program's plan gives the plan the
  reference's gives on the reference's plan (through ``to_dict`` /
  ``from_reference_dict``), with the same applied and skipped hints, in
  ``"auto"`` and ``"force"``;
* ``interp_torch`` on every transformed plan matches ``interp_jax`` on
  the reference's at ``atol=2e-4, rtol=1e-3``, and the bit-exact
  rewrites (``shift_reuse``, ``realign_origin``) equal the untransformed
  ``interp_torch`` run with ``torch.equal``;
* one hand-built plan per rewrite the programs do not reach, and the
  engine's wiring (cache keys, the on-disk cache, the CUDA kernel
  staying layout-oblivious)."""
import numpy as np
import pytest
import torch

import repro.core as rc
from _interp_utils import arrays_for, sizes_for
from repro.core.programs import ALL_PROGRAMS as REF_PROGRAMS
from repro_torch.core import (ALL_PROGRAMS, PlanUnsupported, apply_layout,
                              clear_compile_cache, compile_program,
                              execute_plan, explain, from_reference_dict)
from repro_torch.core.layoutapply import (APPLY_LAYOUT_ENV, EXACT_HINTS,
                                          resolve_apply_mode)
from repro_torch.core.plan import (AxiomPlan, CallPlan, GridDim, InputPlan,
                                   KernelPlan, LanePass, LayoutHint,
                                   OutputPlan, ReadPlan, StepPlan)
from repro_torch.core.plancheck import LANE

TOL = dict(atol=2e-4, rtol=1e-3)
NAMES = sorted(REF_PROGRAMS)


@pytest.fixture(autouse=True)
def _fresh_cache():
    clear_compile_cache()
    yield
    clear_compile_cache()


def _plans(name):
    port = compile_program(ALL_PROGRAMS[name](), backend="interp_torch",
                           device="cpu").kernel_plan
    ref = rc.compile_program(REF_PROGRAMS[name](),
                             backend="interp_jax").kernel_plan
    return port, ref


def _inputs(ref_plan, seed=7):
    return {k: np.array(v) for k, v in
            arrays_for(ref_plan, np.random.default_rng(seed)).items()}


def _run(kplan, arrs):
    return execute_plan(kplan, interpreter="interp_torch",
                        device="cpu")(**arrs)


@pytest.mark.parametrize("mode", ["auto", "force"])
@pytest.mark.parametrize("name", NAMES)
def test_apply_layout_matches_reference(name, mode):
    port, ref = _plans(name)
    sizes = sizes_for(ref)
    got = apply_layout(port, mode=mode, sizes=sizes)
    want = rc.apply_layout(ref, mode=mode, sizes=sizes)
    assert got.applied == want.applied
    assert got.skipped == want.skipped
    assert got.plan == from_reference_dict(want.plan.to_dict())
    assert got.plan.applied_layout == want.plan.applied_layout
    if want.post_report is not None:
        assert got.post_report.redundant_load_ratio == pytest.approx(
            want.post_report.redundant_load_ratio)


@pytest.mark.parametrize("mode", ["auto", "force"])
@pytest.mark.parametrize("name", NAMES)
def test_transformed_plans_execute_like_interp_jax(name, mode):
    port, ref = _plans(name)
    sizes = sizes_for(ref)
    res = apply_layout(port, mode=mode, sizes=sizes)
    arrs = _inputs(ref)
    got = _run(res.plan, arrs)
    jx = rc.apply_layout(ref, mode=mode, sizes=sizes).plan
    want = rc.execute_plan(jx, interpreter="interp_jax")(**arrs)
    base = _run(port, arrs)
    exact = all(k in EXACT_HINTS for k, _, _ in res.applied)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   err_msg=k, **TOL)
        if exact:
            assert torch.equal(got[k], base[k]), k
        else:
            np.testing.assert_allclose(got[k].numpy(), base[k].numpy(),
                                       err_msg=k, **TOL)


def test_programs_exercise_shift_reuse_and_lane_block():
    applied = set()
    for name in NAMES:
        port, ref = _plans(name)
        res = apply_layout(port, mode="force", sizes=sizes_for(ref))
        applied |= {k for k, _, _ in res.applied}
    assert {"shift_reuse", "acc_lane_block"} <= applied


# ---------------------------------------------------------------------------
# Hand-built plans
# ---------------------------------------------------------------------------

def _hand_plan(call, *, i_hi=2, layout_hints=()):
    """A minimal executable one-call plan over u[Nj, Ni + i_hi]."""
    return KernelPlan(
        program="hand",
        loop_order=("j", "i"),
        dim_sizes=(("i", "Ni"), ("j", "Nj")),
        axioms=(AxiomPlan("u", ("j", "i"),
                          (("j", "Nj", 0, 0), ("i", "Ni", 0, i_hi))),),
        goal_outputs=(("v", "v"),),
        calls=(call,),
        layout_hints=tuple(layout_hints),
    ).validate()


def _add2(a, b):
    return a + b


def test_realign_origin_pads_window_bit_exactly():
    """A window whose loads all sit off-lane gains an ``align_pad``
    seating the lowest origin on a lane boundary, and ``interp_torch``
    runs it bit-identically to the unpadded plan (as ``interp_jax``
    does)."""
    call = CallPlan(
        name="hand_n0", grid=(GridDim("j", 0, 0),), vec_dim="i",
        inputs=(InputPlan("u", i_hi=2),),
        steps=(StepPlan("add2", 0,
                        (ReadPlan("in_u", 0, 1, 0), ReadPlan("in_u", 0, 2, 0)),
                        ((("out", 0),),), 0),),
        outputs=(OutputPlan("v", kind="external"),),
        fns=(_add2,))
    kplan = _hand_plan(call, layout_hints=[
        LayoutHint("realign_origin", "hand_n0", "in_u")])
    res = apply_layout(kplan, mode="force")
    assert res.applied == (("realign_origin", "hand_n0", "in_u"),)
    (ispec,) = res.plan.calls[0].inputs
    assert ispec.align_pad == LANE - 1
    u = np.random.default_rng(7).standard_normal((7, 22)).astype(np.float32)
    got, want = _run(res.plan, {"u": u}), _run(kplan, {"u": u})
    assert torch.equal(got["v"], want["v"])
    np.testing.assert_allclose(got["v"].numpy(), u[:, 1:-1] + u[:, 2:],
                               **TOL)


def test_layout_transform_makes_strided_plan_executable():
    """The size-specialized DLT: a 2-strided plan is outside
    ``interp_torch``'s capabilities; after the de-interleave pre-pass
    its reads are unit-stride and it runs."""
    call = CallPlan(
        name="sv_n0", grid=(GridDim("j", 0, 0),), vec_dim="i",
        inputs=(InputPlan("u"),),
        steps=(StepPlan("pairsum", 0,
                        (ReadPlan("in_u", 0, 0, -2, 0, 2),
                         ReadPlan("in_u", 0, 1, -2, 0, 2)),
                        ((("out", 0),),), 0, out_w_off=-11),),
        outputs=(OutputPlan("v", kind="external"),),
        fns=(_add2,))
    kplan = _hand_plan(call, i_hi=0, layout_hints=[
        LayoutHint("layout_transform", "sv_n0", "in_u")])
    with pytest.raises(PlanUnsupported, match="strided_reads"):
        execute_plan(kplan, interpreter="interp_torch", device="cpu")
    res = apply_layout(kplan, mode="force", sizes={"Nj": 7, "Ni": 20})
    assert res.plan.pre_passes == (LanePass("u", 2, 20),)
    u = np.random.default_rng(7).standard_normal((7, 20)).astype(np.float32)
    got = _run(res.plan, {"u": u})["v"].numpy()
    ref = np.zeros_like(u)
    ref[:, :9] = u[:, 0:18:2] + u[:, 1:18:2]
    np.testing.assert_allclose(got, ref, **TOL)


def test_acc_lane_block_prefolds_row_reduction():
    port, ref = _plans("row_sum")
    res = apply_layout(port, mode="force", sizes=sizes_for(ref))
    assert ("acc_lane_block", "row_sum_n0", "rsum_u") in res.applied
    (out,) = [o for o in res.plan.calls[0].outputs if o.lane_block]
    assert out.lane_block == LANE
    u = np.random.default_rng(1).standard_normal((7, 300)).astype(np.float32)
    got = _run(res.plan, {"u": u})["rsum"].numpy()
    np.testing.assert_allclose(got, (u * u).sum(1), **TOL)


# ---------------------------------------------------------------------------
# Engine wiring
# ---------------------------------------------------------------------------

def test_off_mode_and_env_resolution(monkeypatch):
    port, _ = _plans("laplace5")
    res = apply_layout(port, mode="off")
    assert res.plan is port and res.applied == ()
    monkeypatch.delenv(APPLY_LAYOUT_ENV, raising=False)
    assert resolve_apply_mode(None) == "off"
    monkeypatch.setenv(APPLY_LAYOUT_ENV, "force")
    assert resolve_apply_mode(None) == "force"
    with pytest.raises(ValueError, match="apply_layout"):
        resolve_apply_mode("sometimes")


def test_compile_program_modes_split_the_cache():
    prog = ALL_PROGRAMS["laplace5"]
    off = compile_program(prog(), backend="interp_torch", device="cpu")
    auto = compile_program(prog(), backend="interp_torch", device="cpu",
                           apply_layout="auto")
    assert auto is not off
    assert auto.kernel_plan.applied_layout and not off.kernel_plan.applied_layout
    assert auto.base_plan == off.kernel_plan
    assert auto.layout_result.applied == auto.kernel_plan.applied_layout
    u = np.random.default_rng(2).standard_normal((9, 30)).astype(np.float32)
    assert torch.equal(auto.fn(cell=u)["lap"], off.fn(cell=u)["lap"])


def test_cuda_kernel_stays_layout_oblivious():
    """The engine never runs the pass for the CUDA kernel (it, like the
    reference's Pallas kernel, does not execute the constructs)."""
    gen = compile_program(ALL_PROGRAMS["laplace5"](), backend="cuda",
                          device="cpu", apply_layout="force")
    assert gen.layout_result is None
    assert gen.kernel_plan.applied_layout == ()


def test_disk_cache_stores_untransformed_plan(tmp_path):
    from repro_torch.core import PlanCache, program_plan_key
    prog = ALL_PROGRAMS["laplace5"]()
    gen = compile_program(prog, backend="interp_torch", device="cpu",
                          apply_layout="force", plan_cache_dir=tmp_path)
    assert gen.kernel_plan.applied_layout
    stored = PlanCache(tmp_path).get(program_plan_key(prog))
    assert stored is not None and stored.applied_layout == ()
    assert stored == gen.base_plan
    clear_compile_cache()
    warm = compile_program(prog, backend="interp_torch", device="cpu",
                           apply_layout="force", plan_cache_dir=tmp_path)
    assert warm.plan is None and warm.kernel_plan == gen.kernel_plan


def test_explain_renders_applied_vs_advisory():
    text = explain(ALL_PROGRAMS["laplace5"](), device="cpu", verbose=True,
                   apply_layout="force")
    assert "apply mode: force" in text
    assert "applied  shift_reuse [laplace5_n0] in_cell" in text
    assert "redundant-load ratio:" in text
