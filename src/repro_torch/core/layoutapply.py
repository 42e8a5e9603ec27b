"""LayoutApply: the plan->plan transformation pass executing VecScan's hints.

The port's copy of ``repro.core.layoutapply``.  The vectorization
analyzer (:mod:`repro_torch.core.vecscan`) is the *analysis* half of
HFAV's vectorization story: every plan access site classified,
redundancy and occupancy modelled, and advisory
:class:`~repro_torch.core.plan.LayoutHint` records naming the layout
transformation that would fix each finding.  This module is the
*transformation* half — a pure function from a validated
:class:`~repro_torch.core.plan.KernelPlan` to a rewritten KernelPlan that
realizes the hints, drawing on the two stencil-vectorization papers in
PAPERS.md (in-register shuffle reuse across adjacent outputs,
arxiv 2103.08825; DLT lane-dim data-layout transformation,
arxiv 2103.09235):

``shift_reuse``
    Overlapping shifted reads of one resident row of a *streamed
    input* become a single widened load per grid step plus a
    carried-vector stack (:class:`~repro_torch.core.plan.VecLoadPlan`,
    ``CallPlan.vloads``): the value loaded ``k`` steps ago *is* the
    row ``k`` positions behind, so every former re-load becomes a
    register (``vec:``) read.  Bit-exact — the rewritten reads keep
    every coordinate of the originals and only their ``src`` changes.

``realign_origin``
    When no remaining load of a window is lane-aligned, the window
    gains a physical left pad (``align_pad``) seating the lowest
    origin on a lane boundary.  Every access shifts by the same
    amount, so the rewrite is bit-exact.  Applied *after*
    ``shift_reuse`` — one widened aligned load often makes this moot.

``layout_transform``
    A size-specialized DLT: uniformly ``s``-strided reads of a
    streamed input become unit-stride reads of a de-interleaved
    layout, realized as a host-side pre-pass
    (:class:`~repro_torch.core.plan.LanePass`) on the source array; a hint
    targeting an external output instead appends the *inverse*
    re-interleave as a post-pass on the assembled goal.  ``force``
    mode only (the transform is specialized to the concrete lane
    width and changes what feature set the plan demands).

``acc_lane_block``
    A row-kept (``acc_rows``) reduction output gains
    ``lane_block=LANE``: the interpreter pre-folds each partial row
    into lane-wide chunks on the device, shrinking the host's
    per-row cross-lane fold.  ``force`` mode only — pre-folding
    reassociates the reduction (bit-exactness is deliberately given
    up; tests compare with tolerances).

Modes (:func:`resolve_apply_mode`; env ``REPRO_APPLY_LAYOUT``):
``"off"`` returns the plan untouched; ``"auto"`` applies the two
bit-exact rewrites and *keeps the result only when the re-run
analyzer agrees it helps* (redundant-load ratio drops, or a PV002
unaligned-group finding disappears); ``"force"`` applies every
handled kind unconditionally.  The transformed plan re-validates, its
``applied_layout`` record participates in structural equality (so
:meth:`~repro_torch.core.plan.KernelPlan.cache_key` never collides with the
untransformed plan), and the original advisory ``layout_hints``
survive on it for ``explain``'s applied-vs-advisory rendering.

Entry point: :func:`apply_layout`.  The engine
(:func:`repro_torch.core.engine.compile_program`) runs the pass per
compilation when ``apply_layout`` resolves to a non-``"off"`` mode and
the target interpreter declares
:attr:`~repro_torch.core.interpreters.InterpreterSpec.layout_aware`.
"""
from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass
from typing import Optional

from .plan import (KernelPlan, LanePass, LayoutHint, VecLoadPlan)
from .plancheck import LANE

#: Hint kinds this pass can realize, in application order.
HANDLED_HINTS = ("shift_reuse", "realign_origin", "layout_transform",
                 "acc_lane_block")

#: Hint kinds whose rewrite is bit-exact (the ``auto`` subset);
#: the remaining :data:`HANDLED_HINTS` require ``mode="force"``.
EXACT_HINTS = ("shift_reuse", "realign_origin")

#: ``apply_layout`` gating modes.
APPLY_MODES = ("off", "auto", "force")

#: Environment default for the engine's ``apply_layout`` argument.
APPLY_LAYOUT_ENV = "REPRO_APPLY_LAYOUT"


def resolve_apply_mode(mode: Optional[str] = None) -> str:
    """Resolve an ``apply_layout`` argument: ``None`` defers to the
    ``REPRO_APPLY_LAYOUT`` environment variable, defaulting to
    ``"off"``; anything outside :data:`APPLY_MODES` raises."""
    if mode is None:
        mode = os.environ.get(APPLY_LAYOUT_ENV) or "off"
    if mode not in APPLY_MODES:
        raise ValueError(
            f"apply_layout={mode!r}: expected one of {APPLY_MODES}")
    return mode


@dataclass(frozen=True)
class LayoutApplyResult:
    """What one :func:`apply_layout` run did.

    ``plan`` is the (possibly untouched) result plan; ``applied``
    holds one ``(kind, call, target)`` triple per realized hint
    (mirroring ``plan.applied_layout``) and ``skipped`` one
    ``(kind, call, target, reason)`` per hint the pass declined.
    ``pre_report``/``post_report`` are the analyzer's
    :class:`~repro_torch.core.vecscan.VecReport` before and after the
    rewrite (``post_report`` is ``None`` when nothing was applied)."""

    plan: KernelPlan
    applied: tuple = ()
    skipped: tuple = ()
    pre_report: object = None
    post_report: object = None


class _Skip(Exception):
    """Internal: a hint handler declining, carrying the reason."""


# ---------------------------------------------------------------------------
# Per-hint rewrites (each: call -> new call, or raise _Skip(reason))
# ---------------------------------------------------------------------------

def _streamed_inputs(call):
    return {f"in_{i.name}": i for i in call.inputs if not i.scalar}


def _shift_reuse(call, target):
    """Turn >= 2 overlapping reads of one resident row of streamed
    input ``target`` into one carried-vector slot per ``(src, p_off)``
    chain, rewriting the member reads to ``vec:`` register reads.

    Once at least one chain reuses a row, the remaining single-load
    groups of the same target ride along as carry-0 registers: every
    access of the window then flows through the register file, so a
    backend can retire the window's resident storage outright."""
    ispec = _streamed_inputs(call).get(target)
    if ispec is None:
        raise _Skip("target is not a streamed input window")
    reads = [rd for s in call.steps for rd in s.reads if rd.src == target]
    if any(rd.i_stride != 1 for rd in reads):
        raise _Skip("non-unit-stride reads cannot share a vector slot")
    taken = {v.name for v in call.vloads}
    groups: dict = {}
    for rd in reads:
        groups.setdefault(rd.p_off, []).append(rd)
    if not any(len(rds) >= 2 for rds in groups.values()):
        raise _Skip("no row group loads the same resident row twice")
    base = target[3:]
    vloads, rewrite = [], {}
    for p_off, rds in sorted(groups.items()):
        top = max(r.j_off for r in rds)
        bot = min(r.j_off for r in rds)
        c0 = min(r.col0 for r in rds)
        c1 = max(r.col0 + r.w_off for r in rds)
        ahead = (not ispec.plane and top > ispec.lead) or \
            (ispec.plane and p_off == ispec.p_lead and top > ispec.lead)
        if ahead:
            if len(rds) < 2:
                continue  # rider group the stream cannot feed yet
            raise _Skip("chain reaches ahead of the stream lead"
                        if not ispec.plane else
                        "chain reaches ahead of the newest plane's "
                        "row lead")
        name = base if len(groups) == 1 else f"{base}_p{p_off}"
        if name in taken:
            raise _Skip(f"vector-slot name {name!r} already taken")
        vloads.append(VecLoadPlan(name, target, top, p_off,
                                  c0, c1 - c0, top - bot))
        rewrite[p_off] = f"vec:{name}"
    steps = tuple(
        dataclasses.replace(s, reads=tuple(
            dataclasses.replace(rd, src=rewrite[rd.p_off])
            if rd.src == target and rd.p_off in rewrite else rd
            for rd in s.reads))
        for s in call.steps)
    return dataclasses.replace(call, steps=steps,
                               vloads=call.vloads + tuple(vloads))


def _realign_origin(call, target):
    """Left-pad the resident window of ``target`` so its lowest
    remaining load origin (direct reads and carried-vector loads alike)
    lands on a lane boundary."""
    ins = _streamed_inputs(call)
    windows = {w.name: w for w in call.windows}
    obj = ins.get(target) or windows.get(target)
    if obj is None:
        raise _Skip("target is not a resident window")
    if obj.align_pad:
        raise _Skip("window is already re-aligned")
    origins = [rd.col0 - obj.i_lo for s in call.steps for rd in s.reads
               if rd.src == target]
    origins += [v.col0 - obj.i_lo for v in call.vloads
                if v.src == target]
    if not origins:
        raise _Skip("no remaining loads of the target "
                    "(shift_reuse absorbed them)")
    if any(o % LANE == 0 for o in origins):
        raise _Skip("an aligned anchor load already exists")
    pad = (LANE - (min(origins) % LANE)) % LANE
    padded = dataclasses.replace(obj, align_pad=pad)
    if target in ins:
        return dataclasses.replace(call, inputs=tuple(
            padded if f"in_{i.name}" == target else i
            for i in call.inputs))
    return dataclasses.replace(call, windows=tuple(
        padded if w.name == target else w for w in call.windows))


def _layout_transform(call, target, params, ni):
    """Size-specialized DLT.  Input target: rewrite uniformly strided
    reads to unit stride and return the de-interleave
    :class:`~repro_torch.core.plan.LanePass` to run as a pre-pass.  External
    output target: return the inverse re-interleave as a post-pass on
    the assembled goal.  Returns ``(new_call, where, lane_pass)`` with
    ``where`` one of ``"pre"``/``"post"``."""
    if ni is None:
        raise _Skip("needs concrete sizes (the transform is "
                    "size-specialized)")
    p = dict(params)
    out = next((o for o in call.outputs if o.name == target), None)
    if out is not None:
        s = int(p.get("stride", 0))
        if s <= 1:
            raise _Skip("no stride parameter on the hint")
        if out.kind != "external":
            raise _Skip("inverse seating applies to external outputs "
                        "only")
        if ni % s:
            raise _Skip(f"lane width {ni} not divisible by stride {s}")
        return call, "post", LanePass(out.name, s, ni)
    ispec = _streamed_inputs(call).get(target)
    if ispec is None:
        raise _Skip("target is neither a streamed input nor an output")
    if ispec.plane:
        raise _Skip("plane-window inputs are not transformed")
    if ispec.i_lo != 0:
        raise _Skip("window origin is not at column 0")
    width = ni + ispec.i_hi
    reads = [rd for st in call.steps for rd in st.reads
             if rd.src == target]
    strides = {rd.i_stride for rd in reads}
    if len(strides) != 1 or 1 in strides:
        raise _Skip("reads are not uniformly strided")
    s = strides.pop()
    if width % s:
        raise _Skip(f"window width {width} not divisible by stride {s}")
    if any((ni + rd.w_off) % s for rd in reads):
        raise _Skip("a read span is not divisible by the stride")

    def remap(rd):
        m = (ni + rd.w_off) // s
        col0 = (rd.col0 % s) * (width // s) + rd.col0 // s
        return dataclasses.replace(rd, col0=col0, w_off=m - ni,
                                   i_stride=1)

    steps = tuple(
        dataclasses.replace(st, reads=tuple(
            remap(rd) if rd.src == target else rd for rd in st.reads))
        for st in call.steps)
    return (dataclasses.replace(call, steps=steps), "pre",
            LanePass(ispec.name, s, width))


def _acc_lane_block(call, target):
    """Give the named ``acc_rows`` output a device pre-fold width of
    one lane."""
    out = next((o for o in call.outputs if o.name == target), None)
    if out is None:
        raise _Skip("target names no output of the call")
    if out.kind != "acc_rows" or out.reduce_idx is None:
        raise _Skip("target is not a lane-reduced acc_rows output")
    if out.lane_block:
        raise _Skip("output is already lane-blocked")
    blocked = dataclasses.replace(out, lane_block=LANE)
    return dataclasses.replace(call, outputs=tuple(
        blocked if o.name == target else o for o in call.outputs))


# ---------------------------------------------------------------------------
# The pass
# ---------------------------------------------------------------------------

def _pv002_count(report) -> int:
    return sum(1 for d in report.diagnostics if d.code == "PV002")


def apply_layout(kplan: KernelPlan, *, mode: str = "auto",
                 sizes: Optional[dict] = None) -> LayoutApplyResult:
    """Apply the plan's serialized layout hints, per ``mode``.

    ``mode`` is one of :data:`APPLY_MODES` (``"off"`` returns the plan
    untouched with every hint advisory); ``sizes``
    (``{size symbol: int}``, see
    :func:`repro_torch.core.plancheck.sizes_from_arrays`) enables the
    size-specialized ``layout_transform`` rewrite and concretizes the
    before/after analyzer reports.  Plans with no attached hints are
    analyzed on the fly (:func:`repro_torch.core.vecscan.scan_plan`), so the
    pass works on hand-built plans too.  The result plan is
    re-validated; under ``"auto"`` it is kept only when the re-run
    analyzer confirms the predicted improvement (see module
    docstring)."""
    from .vecscan import scan_plan
    mode = resolve_apply_mode(mode)
    if mode == "off":
        return LayoutApplyResult(plan=kplan)
    pre = scan_plan(kplan, sizes=sizes)
    hints = kplan.layout_hints or pre.hints
    dim_sym = dict(kplan.dim_sizes)
    calls = {c.name: c for c in kplan.calls}
    applied: list = []
    skipped: list = []
    order = {k: n for n, k in enumerate(HANDLED_HINTS)}
    pre_passes: list = []
    post_passes: list = []
    for h in sorted(hints, key=lambda h: (order.get(h.kind, 99),
                                          h.call, h.target)):
        if h.kind not in HANDLED_HINTS:
            skipped.append((h.kind, h.call, h.target,
                            "unhandled hint kind"))
            continue
        if mode != "force" and h.kind not in EXACT_HINTS:
            skipped.append((h.kind, h.call, h.target,
                            "not bit-exact: force mode only"))
            continue
        call = calls.get(h.call)
        if call is None or not call.has_grid:
            skipped.append((h.kind, h.call, h.target,
                            "hint names no grid call of the plan"))
            continue
        ni = None
        sym = dim_sym.get(call.vec_dim)
        if sizes and sym in sizes:
            ni = int(sizes[sym])
        try:
            if h.kind == "shift_reuse":
                calls[h.call] = _shift_reuse(call, h.target)
            elif h.kind == "realign_origin":
                calls[h.call] = _realign_origin(call, h.target)
            elif h.kind == "layout_transform":
                new_call, where, lp = _layout_transform(
                    call, h.target, h.params, ni)
                calls[h.call] = new_call
                (pre_passes if where == "pre" else post_passes).append(lp)
            else:  # acc_lane_block
                calls[h.call] = _acc_lane_block(call, h.target)
        except _Skip as e:
            skipped.append((h.kind, h.call, h.target, str(e)))
            continue
        applied.append((h.kind, h.call, h.target))
    if not applied:
        return LayoutApplyResult(plan=kplan, skipped=tuple(skipped),
                                 pre_report=pre)
    candidate = dataclasses.replace(
        kplan,
        calls=tuple(calls[c.name] for c in kplan.calls),
        pre_passes=kplan.pre_passes + tuple(pre_passes),
        post_passes=kplan.post_passes + tuple(post_passes),
        applied_layout=kplan.applied_layout + tuple(applied),
    ).validate()
    post = scan_plan(candidate, sizes=sizes)
    if mode == "auto":
        better = post.redundant_load_ratio \
            < pre.redundant_load_ratio - 1e-9 \
            or _pv002_count(post) < _pv002_count(pre)
        if not better:
            skipped.extend(
                (k, c, t, "auto: re-run analyzer predicts no "
                          "improvement") for k, c, t in applied)
            return LayoutApplyResult(plan=kplan, skipped=tuple(skipped),
                                     pre_report=pre)
    return LayoutApplyResult(plan=candidate, applied=tuple(applied),
                             skipped=tuple(skipped), pre_report=pre,
                             post_report=post)


def render_apply(result: LayoutApplyResult, mode: str) -> list[str]:
    """Human-readable applied-vs-advisory lines for
    ``explain(..., verbose=True)``."""
    lines = [f"  apply mode: {mode}"]
    if mode == "off":
        lines.append("  every hint stays advisory (see the "
                     "vectorization hints above)")
        return lines
    hints = result.plan.layout_hints
    if not hints and result.pre_report is not None:
        hints = result.pre_report.hints
    done = set(result.applied)
    reasons = {(k, c, t): r for k, c, t, r in result.skipped}
    for h in hints:
        key = (h.kind, h.call, h.target)
        if key in done:
            lines.append(f"  applied  {h.kind} [{h.call}] {h.target}")
        elif key in reasons:
            lines.append(f"  skipped  {h.kind} [{h.call}] {h.target}: "
                         f"{reasons[key]}")
        else:
            lines.append(f"  advisory {h.kind} [{h.call}] {h.target}: "
                         f"{h.note}")
    if result.pre_report is not None and result.post_report is not None:
        lines.append(
            f"  redundant-load ratio: "
            f"{result.pre_report.redundant_load_ratio:.2f} -> "
            f"{result.post_report.redundant_load_ratio:.2f}")
    return lines
