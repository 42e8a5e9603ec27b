"""PlanCheck: a whole-plan semantic static analyzer for the KernelPlan IR.

The paper's contribution is *analysis* — abstract dependence
relationships of kernels in loop nests and access-pattern proofs that
justify eliding storage (HFAV §3.2–3.5).  The KernelPlan IR
(:mod:`repro_torch.core.plan`) encodes those decisions declaratively: rolling
and plane VMEM windows, software-pipeline leads, per-step read/write
sets, accumulator validity predicates.  The ``require_*`` validate pass
checks each piece *locally*; this module proves the **whole plan**
hazard-free before anything runs — the safety gate for mutated plans
(an autotuner), hand-built plans, and deserialized cache
entries.

Four analyses over a validated :class:`~repro_torch.core.plan.KernelPlan`:

1. **Dependence/race check** — the per-step read/write sets are
   simulated symbolically across the nest's grid: every read of a
   produced value must be dominated by its write at the correct lead.
   Same-step (``local``) reads and same-slot window reads at the
   producer's own lead are ordered by step position (RAW); reads of
   slots the rotating window has already recycled are write-after-read
   hazards surfaced as residency violations (WAR).
2. **Window-bounds / halo-coverage proof** — for every streamed or
   plane-window read at offset ``(p_off, j_off, i_off)``, the access
   must land inside the resident ``(p_stages, rows, width)`` window
   given the declared leads and canonical ranges, *and* inside the
   positions the producer actually computes (grid warm-up coverage) —
   a static guarantee that no DMA'd halo row or plane is missing.
   Consumer requirements are propagated backward through the step
   graph (an interval dataflow fixpoint), so only positions that feed
   a kept output are constrained.
3. **VMEM footprint estimate** — :func:`vmem_bytes` mirrors the
   interpreter's scratch allocation (``build_call``'s shapes,
   lane-padded) and warns above a configurable budget
   (:data:`DEFAULT_VMEM_BUDGET`, ~16 MiB/core on TPU).
4. **Dead-store / unused-window detection** — windows, locals,
   accumulators, and cross-call outputs written but never read
   downstream: exactly the storage-elision opportunities the paper
   targets, surfaced instead of silently carried.

Diagnostic codes (the live table is docs/ARCHITECTURE.md, guarded by
``scripts/check_docs.sh``):

====== ======== =====================================================
code   severity meaning
====== ======== =====================================================
PC000  error    plan failed to load/validate (structural failure)
PC001  error    read before write (step-order race on a same-step
                value or same-slot window row)
PC002  error    window-bounds violation (access outside the resident
                window, the producer's coverage, or the grid warm-up)
PC003  warning  VMEM footprint over budget
PC004  warning  dead store (window/local/output written, never read)
PC005  error    lead/lag mismatch (reading data the stream or
                producer has not yet made resident)
PC006  error    output trim outside the device buffer
PC007  warning  accumulator never combined or never emitted
PC008  error    plan needs features outside the target interpreter's
                declared capability set (registry mismatch)
====== ======== =====================================================

Entry points: :func:`check_plan` (analyzer), :func:`check_call`
(single nest), :func:`vmem_bytes` / :func:`vmem_report` /
:func:`render_vmem` (footprint model), :func:`sizes_from_arrays`
(resolve symbolic dims from concrete array shapes),
:func:`resolve_check_mode` (the ``compile_program(check_plans=...)``
contract).  CLI: ``scripts/plan_lint.py``.
"""
from __future__ import annotations

import os
from dataclasses import dataclass, replace
from typing import Optional, Sequence

from .plan import CallPlan, KernelPlan, StepPlan, WindowPlan

#: Default VMEM budget for PC003: ~16 MiB/core (TPU v4/v5 VMEM size).
DEFAULT_VMEM_BUDGET = 16 * 1024 * 1024

#: Environment override for the PC003 budget (bytes).
VMEM_BUDGET_ENV = "REPRO_VMEM_BUDGET_BYTES"

#: ``compile_program(check_plans=...)`` modes (env: REPRO_CHECK_PLANS).
CHECK_MODES = ("off", "warn", "error")

#: Environment override for the engine's default check mode.
CHECK_PLANS_ENV = "REPRO_CHECK_PLANS"

#: Interpreter lane width (kept in sync with kernels/stencil2d).
LANE = 128

#: Fixpoint iteration clamp half-width: requirement intervals are
#: bounded to the grid range widened by this many positions, so cyclic
#: (self-recurrent) plans terminate instead of diverging.
_CLAMP_SLACK = 64


class PlanCheckError(Exception):
    """A plan carries error-severity diagnostics under
    ``check_plans="error"``.  ``.diagnostics`` holds the full list."""

    def __init__(self, message: str, diagnostics=()):  # noqa: D107
        super().__init__(message)
        self.diagnostics = tuple(diagnostics)


class PlanCheckWarning(UserWarning):
    """Warning category for ``check_plans="warn"`` findings."""


@dataclass(frozen=True)
class Diagnostic:
    """One structured analyzer finding.

    ``code`` is a stable ``PCnnn`` identifier (table in the module
    docstring and docs/ARCHITECTURE.md), ``severity`` is ``"error"``
    or ``"warning"``, ``var`` names the offending variable / window /
    output, ``nest`` the owning call (empty for plan-level findings),
    and ``detail`` is the human-readable explanation."""

    code: str
    severity: str
    var: str
    nest: str
    detail: str

    def __str__(self) -> str:
        where = f" [{self.nest}]" if self.nest else ""
        return f"{self.code} {self.severity}{where} {self.var}: {self.detail}"


def has_errors(diagnostics: Sequence[Diagnostic]) -> bool:
    """Whether any finding is error-severity (the lint exit gate)."""
    return any(d.severity == "error" for d in diagnostics)


def resolve_check_mode(mode: Optional[str]) -> str:
    """Resolve a ``check_plans`` argument: ``None`` defers to the
    ``REPRO_CHECK_PLANS`` environment variable, defaulting to
    ``"warn"``; anything outside :data:`CHECK_MODES` raises."""
    if mode is None:
        mode = os.environ.get(CHECK_PLANS_ENV) or "warn"
    if mode not in CHECK_MODES:
        raise ValueError(
            f"check_plans={mode!r}: expected one of {CHECK_MODES}")
    return mode


def vmem_budget(budget: Optional[int] = None) -> int:
    """Resolve the PC003 budget: explicit argument, else the
    ``REPRO_VMEM_BUDGET_BYTES`` env var, else
    :data:`DEFAULT_VMEM_BUDGET`."""
    if budget is not None:
        return int(budget)
    env = os.environ.get(VMEM_BUDGET_ENV)
    return int(env) if env else DEFAULT_VMEM_BUDGET


# ---------------------------------------------------------------------------
# Interval arithmetic over canonical positions [lo, N + hi)
# ---------------------------------------------------------------------------
# Every row/plane extent in the IR has the affine form [c_lo, N + c_hi)
# for the dim's symbolic size N, so requirement propagation closes over
# pairs of constants: interval (a, b) means positions [a, N + b) for
# any (large enough) N.  None is the empty requirement.

def _iv_union(a, b):
    if a is None:
        return b
    if b is None:
        return a
    return (min(a[0], b[0]), max(a[1], b[1]))


def _iv_shift(iv, off: int):
    return None if iv is None else (iv[0] + off, iv[1] + off)


def _iv_clamp(iv, lo: int, hi: int):
    return None if iv is None else (max(iv[0], lo), min(iv[1], hi))


def pad_to_lane(w: int) -> int:
    """Lane-pad one row width: the interpreter allocates every resident
    row at a multiple of :data:`LANE` elements (minimum one lane).
    Shared with :mod:`repro_torch.core.vecscan`'s occupancy model."""
    return max(LANE, ((w + LANE - 1) // LANE) * LANE)


_pad_to_lane = pad_to_lane


# ---------------------------------------------------------------------------
# Per-call structural views
# ---------------------------------------------------------------------------

def _writers(call: CallPlan) -> dict:
    """Map each produced name (``b_<w>``, ``local:<v>``) and output
    index to the list of step indices writing it."""
    table: dict = {}
    for si, step in enumerate(call.steps):
        for targets in step.writes:
            for kind, tgt in targets:
                if kind == "buf":
                    table.setdefault(tgt, []).append(si)
                elif kind == "local":
                    table.setdefault(f"local:{tgt}", []).append(si)
                else:
                    table.setdefault(("out", int(tgt)), []).append(si)
    return table


def _plane_lead(call: CallPlan, step: StepPlan,
                windows: dict) -> int:
    """A step's software-pipeline lead in the plane dim: the plane
    window it writes (producer plane windows run ``p_lead`` tiles
    ahead), else its output's last ``outer_lead``, else 0."""
    for targets in step.writes:
        for kind, tgt in targets:
            if kind == "buf":
                w = windows.get(tgt)
                if w is not None and w.plane:
                    return w.p_lead
    for targets in step.writes:
        for kind, tgt in targets:
            if kind == "out":
                out = call.outputs[int(tgt)]
                if out.outer_lead:
                    return out.outer_lead[-1]
    return 0


def _row_requirements(call: CallPlan, windows: dict, writers: dict):
    """Backward interval dataflow: for every step, the canonical row
    positions (and plane positions, when the grid has outer dims) at
    which its produced value must be *correct* — seeded from output
    extents and accumulator validity predicates, propagated to
    producers through each read's ``(p_off, j_off)`` offset and the
    consumer's leads.  Returns ``(row_req, plane_req)`` lists indexed
    by step position (entries ``None`` when nothing downstream needs
    the step)."""
    n = len(call.steps)
    row_req = [None] * n
    plane_req = [None] * n
    has_outer = call.n_outer >= 1
    for si, step in enumerate(call.steps):
        for targets in step.writes:
            for kind, tgt in targets:
                if kind != "out":
                    continue
                out = call.outputs[int(tgt)]
                if out.kind in ("external", "full", "acc_rows"):
                    row_req[si] = _iv_union(row_req[si],
                                            (out.j_lo, out.j_hi))
                if has_outer and out.outer_lo:
                    plane_req[si] = _iv_union(
                        plane_req[si],
                        (out.outer_lo[-1], out.outer_hi[-1]))
        if step.acc is not None:
            row_req[si] = _iv_union(row_req[si], tuple(step.valid))
            if has_outer:
                ov = (tuple(step.valid_outer[-1])
                      if step.valid_outer else (0, 0))
                plane_req[si] = _iv_union(plane_req[si], ov)
    # clamp bounds keep cyclic plans convergent; the widened range is
    # far outside any real grid so precision is unaffected in practice
    rlo = call.x_lo - _CLAMP_SLACK
    rhi = call.x_hi_off + _CLAMP_SLACK
    for _ in range(4 * n + 8):
        changed = False
        for si, step in enumerate(call.steps):
            rr, pr = row_req[si], plane_req[si]
            if rr is None and pr is None:
                continue
            c_lead = step.lead
            c_plead = _plane_lead(call, step, windows)
            for rd in step.reads:
                key = None
                if rd.src.startswith("local:") or rd.src in windows:
                    key = rd.src
                if key is None:
                    continue
                need_r = _iv_clamp(
                    _iv_shift(rr, rd.j_off - c_lead), rlo, rhi)
                need_p = _iv_clamp(
                    _iv_shift(pr, rd.p_off - c_plead),
                    -_CLAMP_SLACK, _CLAMP_SLACK)
                for pi in writers.get(key, ()):
                    merged = _iv_union(row_req[pi], need_r)
                    if merged != row_req[pi]:
                        row_req[pi] = merged
                        changed = True
                    merged = _iv_union(plane_req[pi], need_p)
                    if merged != plane_req[pi]:
                        plane_req[pi] = merged
                        changed = True
        if not changed:
            break
    return row_req, plane_req


# ---------------------------------------------------------------------------
# Analysis (a) + (b): dependence/race + window-bounds/halo coverage
# ---------------------------------------------------------------------------

def _desugar_call(call: CallPlan) -> CallPlan:
    """Rewrite LayoutApply's carried-vector reads back to the window
    reads they replaced.

    A ``vec:`` register read keeps every coordinate of the original
    read it stands in for (the pass only swaps its ``src``), and the
    carried value at its slot *is* the source row at those
    coordinates, so mapping ``src`` back through the call's vload
    table reproduces the pre-transform call exactly.  The analyses
    then prove the transformed plan on the same footing as the
    original — residency, halo coverage, and the dead-store scan all
    see the true source accesses."""
    if not call.vloads:
        return call
    src_of = {f"vec:{v.name}": v.src for v in call.vloads}
    steps = tuple(
        replace(s, reads=tuple(
            replace(rd, src=src_of[rd.src]) if rd.src in src_of else rd
            for rd in s.reads))
        for s in call.steps)
    return replace(call, steps=steps, vloads=())


def check_call(call: CallPlan, *, nest: Optional[str] = None
               ) -> list[Diagnostic]:
    """Run the size-independent analyses over one stencil call:
    dependence/race ordering (PC001), window residency and halo
    coverage (PC002), lead/lag availability (PC005), output trim
    bounds (PC006), and the dead-store/unused-accumulator scans local
    to the call (PC004/PC007).  Cross-call dead-store detection and
    the VMEM budget live in :func:`check_plan`.  Carried-vector reads
    are desugared back to their source window reads first
    (:func:`_desugar_call`), so transformed plans are proven on the
    same footing as their untransformed originals."""
    nest = call.name if nest is None else nest
    diags: list[Diagnostic] = []
    if not call.has_grid:
        return diags
    call = _desugar_call(call)
    windows = {w.name: w for w in call.windows}
    inputs = {f"in_{i.name}": i for i in call.inputs if not i.scalar}
    writers = _writers(call)
    row_req, plane_req = _row_requirements(call, windows, writers)
    x_lo, x_hi = call.x_lo, call.x_hi_off

    def emit(code, severity, var, detail):
        diags.append(Diagnostic(code, severity, var, nest, detail))

    def newest_plane_rows(si, rd, stream_lead, src):
        """Reads of the plane still being streamed/produced this tile
        are bounded by the row-stream lead and the tile's progress."""
        step = call.steps[si]
        if rd.j_off > stream_lead:
            emit("PC005", "error", src,
                 f"step {step.op} reads row j{rd.j_off:+d} of the "
                 f"newest plane, ahead of its row lead {stream_lead}")
            return
        rr = row_req[si]
        if rr is not None and rr[0] - step.lead + rd.j_off \
                < x_lo + stream_lead:
            emit("PC002", "error", src,
                 f"step {step.op} needs row j{rd.j_off:+d} of the "
                 f"newest plane before the tile has streamed it "
                 f"(first kept step reads position "
                 f"{rr[0] - step.lead + rd.j_off}, streaming starts "
                 f"at {x_lo + stream_lead})")

    for si, step in enumerate(call.steps):
        rr = row_req[si]
        pr = plane_req[si]
        c_plead = _plane_lead(call, step, windows)
        for rd in step.reads:
            if rd.src.startswith("scalar:"):
                continue
            # -- same-step locals: pure step-order dependences --------
            if rd.src.startswith("local:"):
                prods = writers.get(rd.src, ())
                if not prods:
                    emit("PC001", "error", rd.src,
                         f"step {step.op} reads a local that no step "
                         f"writes")
                    continue
                if min(prods) >= si:
                    emit("PC001", "error", rd.src,
                         f"step {step.op} (step #{si}) reads a local "
                         f"written later at step #{min(prods)}: "
                         f"read-before-write race")
                for pi in prods:
                    prod = call.steps[pi]
                    if rd.j_off != prod.lead:
                        emit("PC005", "error", rd.src,
                             f"step {step.op} reads the local at row "
                             f"offset j{rd.j_off:+d} but {prod.op} "
                             f"produces it at lead {prod.lead}: "
                             f"locals carry no window to bridge a "
                             f"lead mismatch")
                    # locals are raw rows: reads address them in
                    # physical element coordinates [0, Ni + out_w_off)
                    if rd.col0 < 0 or rd.col0 + rd.w_off > prod.out_w_off:
                        emit("PC002", "error", rd.src,
                             f"step {step.op} slices elements "
                             f"[{rd.col0}, Ni{rd.col0 + rd.w_off:+d}) "
                             f"of a local row {prod.op} produces with "
                             f"only Ni{prod.out_w_off:+d} elements")
                continue
            # -- streamed inputs --------------------------------------
            ispec = inputs.get(rd.src)
            if ispec is not None:
                if ispec.plane:
                    if rd.p_off > ispec.p_lead:
                        emit("PC005", "error", rd.src,
                             f"step {step.op} reads plane "
                             f"p{rd.p_off:+d} but the stream runs "
                             f"only {ispec.p_lead} tile(s) ahead")
                    elif rd.p_off <= ispec.p_lead - ispec.p_stages:
                        emit("PC002", "error", rd.src,
                             f"step {step.op} reads plane "
                             f"p{rd.p_off:+d}: only planes "
                             f"(p{ispec.p_lead - ispec.p_stages:+d}, "
                             f"p{ispec.p_lead:+d}] of a "
                             f"{ispec.p_stages}-plane window are "
                             f"resident")
                    elif rd.p_off == ispec.p_lead:
                        newest_plane_rows(si, rd, ispec.lead, rd.src)
                else:
                    if rd.j_off > ispec.lead:
                        emit("PC005", "error", rd.src,
                             f"step {step.op} reads row j{rd.j_off:+d} "
                             f"but the stream runs only {ispec.lead} "
                             f"row(s) ahead")
                    elif rd.j_off <= ispec.lead - ispec.stages:
                        emit("PC002", "error", rd.src,
                             f"step {step.op} reads row j{rd.j_off:+d}"
                             f": only rows "
                             f"(j{ispec.lead - ispec.stages:+d}, "
                             f"j{ispec.lead:+d}] of a "
                             f"{ispec.stages}-row window are resident")
                    elif rr is not None and rr[0] - step.lead \
                            + rd.j_off < x_lo + ispec.lead:
                        emit("PC002", "error", rd.src,
                             f"step {step.op} needs row j{rd.j_off:+d}"
                             f" before the pass has streamed it "
                             f"(grid starts at {x_lo}, stream lead "
                             f"{ispec.lead})")
                # array halo coverage: required positions inside the
                # input's declared extent (else the interpreter's edge
                # clamp silently substitutes a wrong row)
                if rr is not None:
                    lo = rr[0] - step.lead + rd.j_off
                    hi = rr[1] - step.lead + rd.j_off
                    if lo < ispec.j_lo or hi > ispec.j_hi:
                        emit("PC002", "error", rd.src,
                             f"step {step.op} needs rows "
                             f"[{lo}, Nj{hi:+d}) of input "
                             f"{ispec.name}, which covers "
                             f"[{ispec.j_lo}, Nj{ispec.j_hi:+d}): "
                             f"halo row missing")
                if rd.col0 < ispec.i_lo or \
                        rd.col0 + rd.w_off > ispec.i_hi:
                    emit("PC002", "error", rd.src,
                         f"step {step.op} reads cols [{rd.col0}, "
                         f"Ni{rd.col0 + rd.w_off:+d}) of input "
                         f"{ispec.name}, which covers "
                         f"[{ispec.i_lo}, Ni{ispec.i_hi:+d}): halo "
                         f"column missing")
                if ispec.plane and pr is not None and ispec.n_outer:
                    plo = pr[0] - c_plead + rd.p_off
                    phi = pr[1] - c_plead + rd.p_off
                    a_lo = ispec.outer_los[-1] if ispec.outer_los else 0
                    a_hi = ispec.outer_his[-1] if ispec.outer_his else 0
                    if plo < a_lo or phi > a_hi:
                        emit("PC002", "error", rd.src,
                             f"step {step.op} needs planes "
                             f"[{plo}, N{phi:+d}) of input "
                             f"{ispec.name}, which covers "
                             f"[{a_lo}, N{a_hi:+d}): halo plane "
                             f"missing")
                continue
            # -- produced VMEM windows --------------------------------
            w = windows.get(rd.src)
            if w is None:
                emit("PC000", "error", rd.src,
                     f"step {step.op} reads an unresolvable source")
                continue
            prods = writers.get(rd.src, ())
            if not prods:
                emit("PC001", "error", rd.src,
                     f"step {step.op} reads window {rd.src} that no "
                     f"step writes")
                continue
            for pi in prods:
                prod = call.steps[pi]
                if rd.col0 < prod.out_col0 or \
                        rd.col0 + rd.w_off > \
                        prod.out_col0 + prod.out_w_off:
                    emit("PC002", "error", rd.src,
                         f"step {step.op} reads cols [{rd.col0}, "
                         f"Ni{rd.col0 + rd.w_off:+d}) but {prod.op} "
                         f"only writes [{prod.out_col0}, "
                         f"Ni{prod.out_col0 + prod.out_w_off:+d})")
                if not w.plane:
                    _check_rolling_read(call, si, pi, rd, w, row_req,
                                        emit)
                else:
                    _check_plane_read(call, si, pi, rd, w, row_req,
                                      plane_req, windows, emit,
                                      newest_plane_rows)
        # grid warm-up coverage: the step must execute at every
        # position anything downstream needs
        if rr is not None:
            if rr[0] - step.lead < x_lo or rr[1] - step.lead > x_hi:
                emit("PC002", "error", step.op,
                     f"positions [{rr[0]}, Nj{rr[1]:+d}) of {step.op} "
                     f"are required but its lead-{step.lead} grid "
                     f"pass only computes [{x_lo + step.lead}, "
                     f"Nj{x_hi + step.lead:+d})")
        if pr is not None and call.n_outer >= 1:
            g = call.grid[-2]
            if pr[0] - c_plead < g.lo or pr[1] - c_plead > g.hi_off:
                emit("PC002", "error", step.op,
                     f"planes [{pr[0]}, N{pr[1]:+d}) of {step.op} are "
                     f"required but its lead-{c_plead} plane pass "
                     f"only computes [{g.lo + c_plead}, "
                     f"N{g.hi_off + c_plead:+d})")
    diags.extend(_check_outputs(call, writers, nest))
    diags.extend(_check_dead_in_call(call, writers, nest))
    return diags


def _check_rolling_read(call, si, pi, rd, w: WindowPlan, row_req, emit):
    """Residency of one read of a rolling (mod-``stages``) window:
    not ahead of the producer's lead (PC005), not past the window's
    retention (PC002), ordered after a same-slot same-step write
    (PC001), and streamed within the current pass (PC002)."""
    step, prod = call.steps[si], call.steps[pi]
    if rd.j_off > prod.lead:
        emit("PC005", "error", rd.src,
             f"step {step.op} reads row j{rd.j_off:+d} but producer "
             f"{prod.op} runs only {prod.lead} row(s) ahead")
        return
    if rd.j_off <= prod.lead - w.stages:
        emit("PC002", "error", rd.src,
             f"step {step.op} reads row j{rd.j_off:+d}: the "
             f"{w.stages}-row window retains only rows "
             f"(j{prod.lead - w.stages:+d}, j{prod.lead:+d}]")
        return
    if rd.j_off == prod.lead and pi >= si:
        emit("PC001", "error", rd.src,
             f"step {step.op} (step #{si}) reads the row {prod.op} "
             f"(step #{pi}) writes this grid step: read ordered "
             f"before its write")
    rr = row_req[si]
    if rr is not None and rr[0] - step.lead + rd.j_off \
            < call.x_lo + prod.lead:
        emit("PC002", "error", rd.src,
             f"step {step.op} needs row j{rd.j_off:+d} before "
             f"{prod.op} has produced it this pass (grid starts at "
             f"{call.x_lo}, producer lead {prod.lead})")


def _check_plane_read(call, si, pi, rd, w: WindowPlan, row_req,
                      plane_req, windows, emit, newest_plane_rows):
    """Residency of one read of a producer plane window: plane slot
    within retention (PC002) and not ahead of the producer's plane
    lead (PC005); newest-plane reads bounded by the row lead; older
    planes must have been fully covered by the producing tile's row
    pass (PC002)."""
    step, prod = call.steps[si], call.steps[pi]
    if rd.p_off > w.p_lead:
        emit("PC005", "error", rd.src,
             f"step {step.op} reads plane p{rd.p_off:+d} but producer "
             f"{prod.op} runs only {w.p_lead} tile(s) ahead")
        return
    if rd.p_off <= w.p_lead - w.p_stages:
        emit("PC002", "error", rd.src,
             f"step {step.op} reads plane p{rd.p_off:+d}: only planes "
             f"(p{w.p_lead - w.p_stages:+d}, p{w.p_lead:+d}] of the "
             f"{w.p_stages}-plane window are resident")
        return
    if rd.p_off == w.p_lead:
        if rd.j_off == prod.lead and pi >= si:
            emit("PC001", "error", rd.src,
                 f"step {step.op} (step #{si}) reads the plane row "
                 f"{prod.op} (step #{pi}) writes this grid step: "
                 f"read ordered before its write")
        newest_plane_rows(si, rd, prod.lead, rd.src)
    else:
        # an older plane: its rows were written by a full row pass of
        # an earlier tile — the grid must cover the plane extent and
        # the read must stay inside it
        if call.x_lo + prod.lead > w.j_lo or \
                call.x_hi_off + prod.lead < w.j_hi:
            emit("PC002", "error", rd.src,
                 f"plane window rows [{w.j_lo}, Nj{w.j_hi:+d}) exceed "
                 f"what producer {prod.op} covers per tile "
                 f"([{call.x_lo + prod.lead}, "
                 f"Nj{call.x_hi_off + prod.lead:+d}))")
        rr = row_req[si]
        if rr is not None:
            lo = rr[0] - step.lead + rd.j_off
            hi = rr[1] - step.lead + rd.j_off
            if lo < w.j_lo or hi > w.j_hi:
                emit("PC002", "error", rd.src,
                     f"step {step.op} needs rows [{lo}, Nj{hi:+d}) of "
                     f"plane window {rd.src}, which keeps "
                     f"[{w.j_lo}, Nj{w.j_hi:+d})")


# ---------------------------------------------------------------------------
# PC006: output trim/seat bounds; PC005: producer/output lead agreement
# ---------------------------------------------------------------------------

def _check_outputs(call: CallPlan, writers: dict,
                   nest: str) -> list[Diagnostic]:
    """The host-side assembly slices device rows
    ``[j_lo - (x_lo + lead), ...)`` and outer blocks
    ``[outer_lo - outer_lead - o_lo, ...)``; both must stay inside
    what the grid produced, and the declared output lead must match
    the producing step's actual lead."""
    diags: list[Diagnostic] = []
    for oi, out in enumerate(call.outputs):
        if out.kind == "acc":
            continue
        t0 = out.j_lo - (call.x_lo + out.lead)
        if t0 < 0 or out.j_hi - out.lead > call.x_hi_off:
            diags.append(Diagnostic(
                "PC006", "error", out.name, nest,
                f"trim rows [{out.j_lo}, Nj{out.j_hi:+d}) at lead "
                f"{out.lead} fall outside the device buffer's "
                f"[{call.x_lo + out.lead}, "
                f"Nj{call.x_hi_off + out.lead:+d})"))
        for d in range(call.n_outer):
            lead = out.outer_lead[d] if out.outer_lead else 0
            lo = out.outer_lo[d] if out.outer_lo else 0
            hi = out.outer_hi[d] if out.outer_hi else 0
            if lo - lead < call.outer_lo[d] or \
                    hi - lead > call.outer_hi_off[d]:
                diags.append(Diagnostic(
                    "PC006", "error", out.name, nest,
                    f"outer-dim {d} trim [{lo}, N{hi:+d}) at lead "
                    f"{lead} falls outside the grid's "
                    f"[{call.outer_lo[d] + lead}, "
                    f"N{call.outer_hi_off[d] + lead:+d})"))
        for si in writers.get(("out", oi), ()):
            step = call.steps[si]
            if out.kind in ("external", "full", "acc_rows") \
                    and step.lead != out.lead:
                diags.append(Diagnostic(
                    "PC005", "error", out.name, nest,
                    f"output declares lead {out.lead} but {step.op} "
                    f"writes it at lead {step.lead}: assembled rows "
                    f"would be shifted by {step.lead - out.lead}"))
    return diags


# ---------------------------------------------------------------------------
# Analysis (d): dead stores, unused windows, idle accumulators
# ---------------------------------------------------------------------------

def _check_dead_in_call(call: CallPlan, writers: dict,
                        nest: str) -> list[Diagnostic]:
    """Call-local storage-elision findings: windows and locals written
    but never read (PC004), and accumulators with no combining step or
    no emitting output (PC007)."""
    diags: list[Diagnostic] = []
    read_srcs = {rd.src for s in call.steps for rd in s.reads}
    for w in call.windows:
        if w.name not in read_srcs:
            diags.append(Diagnostic(
                "PC004", "warning", w.name, nest,
                f"VMEM window ({w.stages} row(s)"
                f"{f', {w.p_stages} plane(s)' if w.plane else ''}) is "
                f"written but never read: elide the window"))
    local_writes = {k for k in writers if isinstance(k, str)
                    and k.startswith("local:")}
    for name in sorted(local_writes - read_srcs):
        diags.append(Diagnostic(
            "PC004", "warning", name, nest,
            "local row is written but never read: dead store"))
    combined = {s.acc for s in call.steps if s.acc is not None}
    emitted = {o.acc for o in call.outputs if o.acc is not None}
    for a in call.accs:
        if a.name not in combined:
            diags.append(Diagnostic(
                "PC007", "warning", a.name, nest,
                "accumulator is never combined by any step (outputs "
                "would hold its init row)"))
        if a.name not in emitted:
            diags.append(Diagnostic(
                "PC007", "warning", a.name, nest,
                "accumulator is never emitted by any output: dead "
                "reduction"))
    return diags


def _check_dead_cross_call(kplan: KernelPlan) -> list[Diagnostic]:
    """Plan-level dead-store scan: a call output consumed by no later
    call input, no host step, and no goal is storage the schedule
    could elide (PC004)."""
    diags: list[Diagnostic] = []
    consumed: set[str] = {var for _, var in kplan.goal_outputs}
    for call in kplan.calls:
        consumed |= {i.name for i in call.inputs}
        for hs in call.host_pre + call.host_post:
            consumed |= set(hs.reads)
    for call in kplan.calls:
        for out in call.outputs:
            if out.name not in consumed:
                diags.append(Diagnostic(
                    "PC004", "warning", out.name, call.name,
                    f"{out.kind} output is consumed by no later call, "
                    f"host step, or goal: dead store"))
    return diags


# ---------------------------------------------------------------------------
# Analysis (c): the VMEM footprint model
# ---------------------------------------------------------------------------

def sizes_from_arrays(kplan: KernelPlan, shapes: dict) -> dict:
    """Resolve the plan's symbolic dim sizes from concrete input-array
    shapes (``{array name: shape tuple}``), mirroring the
    interpreter's runtime resolution through the axiom shape
    contracts.  Returns ``{size symbol: int}``."""
    sizes: dict = {}
    for ax in kplan.axioms:
        shape = shapes.get(ax.array)
        if shape is None:
            continue
        ext = {d: (sym, lo, hi) for d, sym, lo, hi in ax.extents}
        for axis, d in enumerate(ax.dims):
            e = ext.get(d)
            if e is not None and e[0] not in sizes:
                sizes[e[0]] = int(shape[axis]) - (e[2] - e[1])
    return sizes


def _call_sizes(kplan: KernelPlan, call: CallPlan, sizes: dict):
    """Concrete ``(*outer, nj, ni)`` for one call, or ``None`` when a
    needed symbol is missing from ``sizes``."""
    dim_sym = dict(kplan.dim_sizes)
    vals = []
    for g in call.grid[:-1]:
        sym = dim_sym.get(g.dim)
        if sym is None or sym not in sizes:
            return None
        vals.append(int(sizes[sym]))
    for dim in (call.row_dim, call.vec_dim):
        sym = dim_sym.get(dim)
        if sym is None or sym not in sizes:
            return None
        vals.append(int(sizes[sym]))
    return tuple(vals)


def _call_vmem(call: CallPlan, nj: int, ni: int, dtype_bytes: int,
               double_buffer: bool) -> dict:
    """Per-buffer resident bytes for one call, mirroring the
    interpreter's scratch shapes (``build_call``): rolling windows
    ``stages x pad(width)``, plane windows
    ``p_stages x rows x pad(width)``, accumulators ``1 x pad(width)``,
    plus the two-slot DMA staging buffers when double-buffered."""
    ib = int(dtype_bytes)
    report: dict = {}
    arr_ins = [i for i in call.inputs if not i.scalar]
    for i in arr_ins:
        in_w = ni + i.i_hi - i.i_lo + i.align_pad
        if i.plane:
            in_h = nj + i.j_hi - i.j_lo
            report[f"in_{i.name}"] = \
                i.p_stages * in_h * _pad_to_lane(in_w) * ib
        else:
            report[f"in_{i.name}"] = \
                i.stages * _pad_to_lane(in_w) * ib
    for w in call.windows:
        width = _pad_to_lane(ni + w.i_hi - w.i_lo + w.align_pad)
        if w.plane:
            report[w.name] = w.p_stages * (nj + w.j_hi - w.j_lo) \
                * width * ib
        else:
            report[w.name] = w.stages * width * ib
    for a in call.accs:
        report[a.name] = _pad_to_lane(ni + a.w_off) * ib
    for v in call.vloads:
        report[f"vec:{v.name}"] = \
            (v.carry + 1) * _pad_to_lane(ni + v.w_off) * ib
    if double_buffer and arr_ins:
        for i in arr_ins:
            report[f"dma_{i.name}"] = 2 * (ni + i.i_hi - i.i_lo) * ib
    return report


def vmem_report(kplan: KernelPlan, sizes: dict, *, dtype_bytes: int = 4,
                double_buffer: bool = False) -> dict:
    """Per-nest VMEM footprint: ``{call name: {buffer: bytes, ...,
    "total": bytes}}`` for every grid call whose sizes resolve from
    ``sizes`` (``{size symbol: int}``, see
    :func:`sizes_from_arrays`)."""
    out: dict = {}
    for call in kplan.calls:
        if not call.has_grid:
            continue
        resolved = _call_sizes(kplan, call, sizes)
        if resolved is None:
            continue
        *_, nj, ni = resolved
        rep = _call_vmem(call, nj, ni, dtype_bytes, double_buffer)
        rep["total"] = sum(rep.values())
        out[call.name] = rep
    return out


def vmem_bytes(kplan: KernelPlan, sizes: dict, *, dtype_bytes: int = 4,
               double_buffer: bool = False) -> int:
    """Peak resident VMEM estimate over the plan's nests (calls run
    sequentially, so the plan-level figure is the max per-call
    total)."""
    rep = vmem_report(kplan, sizes, dtype_bytes=dtype_bytes,
                      double_buffer=double_buffer)
    return max((r["total"] for r in rep.values()), default=0)


def render_vmem(kplan: KernelPlan, *, dtype_bytes: int = 4) -> list[str]:
    """Symbolic per-nest VMEM formulas for ``explain(verbose=True)``:
    one line per resident buffer with the lane-padded shape algebra,
    usable without concrete sizes."""
    lines: list[str] = []
    ib = int(dtype_bytes)
    for call in kplan.calls:
        if not call.has_grid:
            continue
        lines.append(f"  {call.name}:")
        for i in call.inputs:
            if i.scalar:
                continue
            w = f"pad(Ni{i.i_hi - i.i_lo:+d})"
            if i.plane:
                lines.append(
                    f"    in_{i.name}: {i.p_stages} x "
                    f"(Nj{i.j_hi - i.j_lo:+d}) x {w} x {ib}B")
            else:
                lines.append(f"    in_{i.name}: {i.stages} x {w} x {ib}B")
        for wp in call.windows:
            w = f"pad(Ni{wp.i_hi - wp.i_lo:+d})"
            if wp.plane:
                lines.append(
                    f"    {wp.name}: {wp.p_stages} x "
                    f"(Nj{wp.j_hi - wp.j_lo:+d}) x {w} x {ib}B")
            else:
                lines.append(f"    {wp.name}: {wp.stages} x {w} x {ib}B")
        for a in call.accs:
            lines.append(f"    {a.name}: 1 x pad(Ni{a.w_off:+d}) x {ib}B")
    return lines


def _check_vmem(kplan: KernelPlan, sizes: dict, dtype_bytes: int,
                double_buffer: bool,
                budget: Optional[int]) -> list[Diagnostic]:
    limit = vmem_budget(budget)
    diags = []
    rep = vmem_report(kplan, sizes, dtype_bytes=dtype_bytes,
                      double_buffer=double_buffer)
    for name, r in rep.items():
        if r["total"] > limit:
            top = sorted((v, k) for k, v in r.items() if k != "total")
            biggest = ", ".join(f"{k}={v}" for v, k in top[-3:][::-1])
            diags.append(Diagnostic(
                "PC003", "warning", name, name,
                f"estimated resident VMEM {r['total']} B exceeds the "
                f"{limit} B budget (largest: {biggest})"))
    return diags


# ---------------------------------------------------------------------------
# Entry point
# ---------------------------------------------------------------------------

def check_plan(kplan: KernelPlan, *, sizes: Optional[dict] = None,
               dtype_bytes: int = 4, double_buffer: bool = False,
               budget: Optional[int] = None, validate: bool = True,
               interpreter: Optional[str] = None) -> list[Diagnostic]:
    """Run every analysis over a :class:`KernelPlan` and return the
    diagnostics (empty list = hazard-free).

    Structural validation runs first (``validate=False`` to skip for a
    plan already validated); a failure becomes a single ``PC000`` and
    the semantic analyses are skipped — their assumptions don't hold
    on a malformed plan.  ``sizes`` (``{size symbol: int}``) enables
    the VMEM budget check (PC003) against ``budget`` /
    ``REPRO_VMEM_BUDGET_BYTES`` / :data:`DEFAULT_VMEM_BUDGET`; without
    sizes the footprint is symbolic and PC003 is skipped.
    ``interpreter`` names a registered plan interpreter
    (:mod:`repro_torch.core.interpreters`): the plan's feature set
    (:meth:`KernelPlan.features`) is checked against that
    interpreter's declared capabilities, and each missing feature
    becomes a ``PC008`` error — the static-analysis twin of the typed
    :class:`~repro_torch.core.interpreters.PlanUnsupported` raised at build
    time."""
    if validate:
        try:
            kplan.validate()
        except Exception as e:
            return [Diagnostic("PC000", "error", kplan.program, "",
                               f"plan failed validation: {e}")]
    diags: list[Diagnostic] = []
    if interpreter is not None:
        from .interpreters import get_interpreter
        spec = get_interpreter(interpreter)
        for feat in sorted(kplan.features() - spec.capabilities):
            diags.append(Diagnostic(
                "PC008", "error", feat, "",
                f"plan requires feature {feat!r} outside interpreter "
                f"{spec.name!r} declared capabilities"))
    for call in kplan.calls:
        diags.extend(check_call(call))
    diags.extend(_check_dead_cross_call(kplan))
    if sizes:
        diags.extend(_check_vmem(kplan, sizes, dtype_bytes,
                                 double_buffer, budget))
    order = {"error": 0, "warning": 1}
    diags.sort(key=lambda d: (order.get(d.severity, 2), d.nest, d.code))
    return diags
