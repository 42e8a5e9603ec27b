"""VecScan: static vectorization & access-pattern analyzer for KernelPlans.

HFAV's second pillar — "determining data access patterns for
stencil-like array accesses ... used to elide storage and improve
vectorization" (HFAV §3.5) — needs an analysis that proves plans
*fast*, not just safe (:mod:`repro_torch.core.plancheck` does safe).  This
module walks a validated :class:`~repro_torch.core.plan.KernelPlan` and, for
every read/write site of every step, classifies the **lane-dim access
pattern** the interpreter will execute, following Autovesk's
graph-level access classification (arxiv 2301.01018):

========== ==========================================================
class      meaning
========== ==========================================================
aligned    contiguous load/store whose physical origin is a multiple
           of the lane width (one full-vector access)
shifted    contiguous but lane-crossing: origin not lane-aligned —
           a shifted full-vector load (two loads + combine, or one
           unaligned load; the in-register-reuse target of
           arxiv 2103.08825)
strided    non-unit lane-dim element stride
           (:attr:`~repro_torch.core.plan.ReadPlan.i_stride`)
broadcast  a scalar operand splatted across lanes
gather     per-lane indexed access: the span is not statically
           contained in the resident buffer, so the interpreter
           must clamp/select per lane
register   a ``vec:`` carried-vector read (LayoutApply's
           ``shift_reuse`` rewrite): served from the in-register
           carry stack, no memory access at all — the matching
           vload is costed once per grid step instead
unknown    the source does not resolve — emitted as a PV000 error
           (golden plans must never produce one)
========== ==========================================================

On top of the classification sits a **vector efficiency model**:

* **redundant-load ratio** — elements loaded per grid step vs unique
  elements touched; overlapping shifted reads of one resident row
  (the ``u[j][i-1]``/``u[j][i]``/``u[j][i+1]`` triple) load the same
  lanes repeatedly, the exact redundancy the shift-reuse
  transformation of arxiv 2103.08825 eliminates;
* **lane occupancy** — useful row width over lane-padded allocated
  width (needs concrete sizes), the padding-waste metric;
* **window-slot reuse distance** — how far back consumers reach into
  each rolling/plane window vs the slots retained (slack = elidable
  storage, the paper's storage-elision knob);
* **bytes moved vs bytes needed** — the per-grid-step traffic the
  redundancy costs, reported next to measured wall time in
  ``BENCH_<pr>.json`` so the static model and reality can be
  correlated.

Findings surface three ways: ``PV`` diagnostics (table below; same
:class:`~repro_torch.core.plancheck.Diagnostic` shape as the PC family, so
``scripts/plan_lint.py --vec`` merges both), the structured
:class:`VecReport` (stable :meth:`~VecReport.to_dict` for benchmarks
and the autotuner), and advisory :class:`~repro_torch.core.plan.LayoutHint`
records (:func:`attach_layout_hints`) naming the transformation a
future layout pass should apply.

Diagnostic codes (the live table is docs/ARCHITECTURE.md, guarded by
``scripts/check_docs.sh``):

====== ======== =====================================================
code   severity meaning
====== ======== =====================================================
PV000  error    access site failed to classify (unresolvable source)
PV001  warning  per-lane gather on a step read
PV002  warning  unaligned row group (no lane-aligned anchor load)
PV003  warning  acc_rows output forces a cross-lane fold per row
PV004  warning  lane occupancy below 50% (padding waste)
PV005  warning  redundant overlapping loads of one resident row
PV006  warning  non-unit lane stride on a step read
====== ======== =====================================================

Entry points: :func:`scan_plan` (analyzer), :func:`render_vec`
(``explain(verbose=True)`` rendering), :func:`attach_layout_hints`
(plan annotation), :func:`auto_vec_reject` (the ``backend="auto"``
tiebreaker).  CLI: ``scripts/plan_lint.py --vec``.
"""
from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass
from typing import Optional

from .plan import CallPlan, KernelPlan, LayoutHint
from .plancheck import LANE, Diagnostic, pad_to_lane

#: Access-pattern classes, in decreasing order of vector efficiency
#: (``register`` costs nothing: it is LayoutApply's carried-vector
#: read, served without touching memory).
ACCESS_CLASSES = ("register", "aligned", "shifted", "strided",
                  "broadcast", "gather", "unknown")

#: PV004 fires when a resident buffer's lane occupancy drops below this.
PV004_OCCUPANCY = 0.5

#: ``backend="auto"`` skips the Pallas executor when the plan-level
#: lane occupancy falls below this floor (env override:
#: :data:`OCCUPANCY_ENV`) — tiny vector dims waste most of every lane.
DEFAULT_MIN_OCCUPANCY = 0.25

#: Environment override for the auto-routing occupancy floor.
OCCUPANCY_ENV = "REPRO_VEC_MIN_OCCUPANCY"

#: Optional auto-routing ceiling on the redundant-load ratio
#: (unset = disabled; the ratio is a modelled cost, not a measured
#: one, so it only routes when the user opts in).
AUTO_RATIO_ENV = "REPRO_VEC_AUTO_MAX_RATIO"


# ---------------------------------------------------------------------------
# Report dataclasses
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class AccessSite:
    """One classified read/write site.

    ``origin`` is the physical lane-dim element offset of the access
    within its resident buffer (column position minus the buffer's
    declared origin), ``width_off`` the span's width delta against the
    vector-dim size (the site covers ``origin .. origin + Ni +
    width_off``), ``stride`` the lane-dim element stride, and ``cls``
    one of :data:`ACCESS_CLASSES`."""

    nest: str
    step: str
    kind: str  # "read" | "write"
    src: str
    j_off: int
    p_off: int
    origin: int
    width_off: int
    stride: int
    cls: str


@dataclass(frozen=True)
class StepVec:
    """Per-step load-efficiency summary.

    ``loaded`` and ``unique`` are affine ``(coef, const)`` element
    counts in the vector-dim size ``Ni`` (elements = coef*Ni + const
    per grid step); ``ratio`` is loaded/unique evaluated at the
    concrete ``Ni`` when sizes were given, else asymptotically
    (leading coefficients).  ``n_groups`` counts distinct resident
    rows read (``(src, j_off, p_off)`` groups) — ``n_reads`` above it
    means overlapping loads of one row (PV005)."""

    nest: str
    op: str
    n_reads: int
    n_groups: int
    loaded: tuple
    unique: tuple
    ratio: float


@dataclass(frozen=True)
class WindowVec:
    """Slot-reuse summary of one rolling/plane window or streamed
    input: consumers reach ``reuse`` slots back (rows, or planes for
    plane windows) out of ``stages`` retained — ``slack`` slots are
    elidable storage."""

    nest: str
    name: str
    stages: int
    reuse: int
    slack: int
    plane: bool = False


@dataclass(frozen=True)
class VecReport:
    """The analyzer's structured result (stable :meth:`to_dict`).

    ``redundant_load_ratio`` is the plan-level loaded/unique element
    ratio; ``lane_occupancy``, ``bytes_moved``/``bytes_needed`` (per
    grid step) and ``ni`` are ``None`` unless concrete sizes were
    given to :func:`scan_plan`."""

    program: str
    sites: tuple
    steps: tuple
    windows: tuple
    diagnostics: tuple
    hints: tuple
    redundant_load_ratio: float
    lane_occupancy: Optional[float] = None
    bytes_moved: Optional[int] = None
    bytes_needed: Optional[int] = None
    ni: Optional[int] = None

    def class_counts(self) -> dict:
        """``{access class: site count}`` over every classified site."""
        counts = {c: 0 for c in ACCESS_CLASSES}
        for s in self.sites:
            counts[s.cls] = counts.get(s.cls, 0) + 1
        return counts

    def summary(self) -> dict:
        """The compact record benchmarks embed per leg."""
        counts = self.class_counts()
        return {
            "vec_redundant_load_ratio": self.redundant_load_ratio,
            "vec_lane_occupancy": self.lane_occupancy,
            "vec_bytes_moved": self.bytes_moved,
            "vec_bytes_needed": self.bytes_needed,
            "vec_classes": {c: n for c, n in counts.items() if n},
            "vec_diagnostics": len(self.diagnostics),
        }

    def to_dict(self) -> dict:
        """JSON-native form (nested dataclasses included)."""
        return dataclasses.asdict(self)

    def render(self) -> list[str]:
        """Human-readable lines for ``explain(..., verbose=True)``."""
        counts = self.class_counts()
        cls = " ".join(f"{c}={n}" for c, n in counts.items() if n)
        lines = [f"  access classes: {cls or 'none'}",
                 f"  redundant-load ratio: "
                 f"{self.redundant_load_ratio:.2f}"
                 + ("" if self.ni is None else f" @ Ni={self.ni}")]
        if self.lane_occupancy is not None:
            lines.append(f"  lane occupancy: {self.lane_occupancy:.2f}")
        if self.bytes_moved is not None:
            lines.append(f"  bytes moved/needed per grid step: "
                         f"{self.bytes_moved}/{self.bytes_needed}")
        for w in self.windows:
            kind = "planes" if w.plane else "rows"
            lines.append(f"  window {w.name} [{w.nest}]: reuse "
                         f"{w.reuse}/{w.stages} {kind}"
                         + (f" (slack {w.slack})" if w.slack else ""))
        for d in self.diagnostics:
            lines.append(f"  {d}")
        for h in self.hints:
            lines.append(f"  hint {h.kind} [{h.call}] {h.target}: "
                         f"{h.note}")
        return lines


def render_vec(report: VecReport) -> list[str]:
    """Module-level alias of :meth:`VecReport.render` (mirrors
    :func:`repro_torch.core.plancheck.render_vmem`)."""
    return report.render()


# ---------------------------------------------------------------------------
# Site resolution + classification
# ---------------------------------------------------------------------------

def _classify(origin: int, res_hi: int, w_off: int, stride: int) -> str:
    """Classify one contained-or-not access: non-unit stride wins,
    then static containment in the resident ``[0, Ni + res_hi)`` span
    (independent of ``Ni`` — both ends carry the same ``Ni`` term),
    then lane alignment of the physical origin."""
    if stride != 1:
        return "strided"
    if origin < 0 or origin + w_off > res_hi:
        return "gather"
    if origin % LANE == 0:
        return "aligned"
    return "shifted"


def _writer_steps(call: CallPlan) -> dict:
    table: dict = {}
    for si, step in enumerate(call.steps):
        for targets in step.writes:
            for kind, tgt in targets:
                key = tgt if kind == "buf" else (
                    f"local:{tgt}" if kind == "local" else ("out", int(tgt)))
                table.setdefault(key, []).append(si)
    return table


def _resolve_read(call, rd, inputs, windows, writers, vloads=None):
    """``(origin, resident hi offset, forced class or None)`` for one
    read site — physical coordinates per the interpreter's buffer
    layouts (inputs/windows store ``[i_lo, Ni + i_hi)`` at physical
    ``align_pad``; locals are raw rows addressed from ``0``;
    ``vec:`` reads resolve inside their carried vector)."""
    if rd.src.startswith("scalar:"):
        return 0, 0, "broadcast"
    if rd.src.startswith("vec:"):
        v = (vloads or {}).get(rd.src)
        if v is None:
            return 0, 0, "unknown"
        return rd.col0 - v.col0, v.w_off, "register"
    ispec = inputs.get(rd.src)
    if ispec is not None:
        return (rd.col0 - ispec.i_lo + ispec.align_pad,
                ispec.i_hi - ispec.i_lo + ispec.align_pad, None)
    w = windows.get(rd.src)
    if w is not None:
        return (rd.col0 - w.i_lo + w.align_pad,
                w.i_hi - w.i_lo + w.align_pad, None)
    if rd.src.startswith("local:"):
        prods = writers.get(rd.src, ())
        hi = max((call.steps[pi].out_w_off for pi in prods), default=0)
        return rd.col0, hi, None
    return 0, 0, "unknown"


# ---------------------------------------------------------------------------
# The analyzer
# ---------------------------------------------------------------------------

def _aff_eval(aff, ni):
    return aff[0] * ni + aff[1]


def _ratio(loaded, unique, ni):
    if ni is not None:
        num, den = _aff_eval(loaded, ni), _aff_eval(unique, ni)
    else:
        num, den = loaded[0], unique[0]
        if den == 0:  # constant-width spans: compare the constants
            num, den = loaded[1], unique[1]
    return num / den if den else 1.0


def scan_plan(kplan: KernelPlan, *, sizes: Optional[dict] = None,
              dtype_bytes: int = 4) -> VecReport:
    """Run the vectorization analysis over a validated plan.

    ``sizes`` (``{size symbol: int}``, see
    :func:`repro_torch.core.plancheck.sizes_from_arrays`) enables the
    concrete half of the model — lane occupancy, PV004, exact
    redundant-load ratios and byte counts; without it every figure is
    the size-independent asymptotic form and PV004 is skipped."""
    dim_sym = dict(kplan.dim_sizes)
    sites: list[AccessSite] = []
    steps_v: list[StepVec] = []
    windows_v: list[WindowVec] = []
    diags: list[Diagnostic] = []
    hints: list[LayoutHint] = []
    tot_loaded = [0.0, 0.0]
    tot_unique = [0.0, 0.0]
    occ_useful = 0.0
    occ_padded = 0.0
    report_ni = None

    def emit(code, severity, var, nest, detail):
        diags.append(Diagnostic(code, severity, var, nest, detail))

    def hint(kind, call, target, params, note):
        key = (kind, call, target)
        if key not in {(h.kind, h.call, h.target) for h in hints}:
            hints.append(LayoutHint(kind, call, target,
                                    tuple(sorted(params)), note))

    for call in kplan.calls:
        if not call.has_grid:
            continue
        ni = None
        sym = dim_sym.get(call.vec_dim)
        if sizes and sym in sizes:
            ni = int(sizes[sym])
            if report_ni is None:
                report_ni = ni
        inputs = {f"in_{i.name}": i for i in call.inputs if not i.scalar}
        windows = {w.name: w for w in call.windows}
        vloads = {f"vec:{v.name}": v for v in call.vloads}
        writers = _writer_steps(call)
        # reach-back per source, for the window reuse-distance model
        min_j: dict = {}
        min_p: dict = {}

        # carried-vector loads: one widened load per grid step each
        # (their ``vec:`` consumers below are free register reads)
        for v in call.vloads:
            ispec = inputs.get(v.src)
            pad = ispec.align_pad if ispec is not None else 0
            i_lo = ispec.i_lo if ispec is not None else 0
            res_hi = (ispec.i_hi - i_lo + pad) if ispec is not None else 0
            origin = v.col0 - i_lo + pad
            cls = _classify(origin, res_hi, v.w_off, 1)
            sites.append(AccessSite(
                call.name, f"vload:{v.name}", "read", v.src, v.j_off,
                v.p_off, origin, v.w_off, 1, cls))
            tot_loaded[0] += 1.0
            tot_loaded[1] += v.w_off
            tot_unique[0] += 1.0
            tot_unique[1] += v.w_off
            if v.src in inputs:
                min_j[v.src] = min(min_j.get(v.src, v.j_off), v.j_off)
                min_p[v.src] = min(min_p.get(v.src, v.p_off), v.p_off)

        for step in call.steps:
            groups: dict = {}
            loaded = [0.0, 0.0]
            for rd in step.reads:
                origin, res_hi, forced = _resolve_read(
                    call, rd, inputs, windows, writers, vloads)
                cls = forced or _classify(origin, res_hi, rd.w_off,
                                          rd.i_stride)
                sites.append(AccessSite(
                    call.name, step.op, "read", rd.src, rd.j_off,
                    rd.p_off, origin, rd.w_off, rd.i_stride, cls))
                if cls == "unknown":
                    emit("PV000", "error", rd.src, call.name,
                         f"step {step.op} reads an unresolvable "
                         f"source: access pattern unclassifiable")
                    continue
                if cls in ("broadcast", "register"):
                    continue
                if rd.src in inputs or rd.src in windows:
                    min_j[rd.src] = min(min_j.get(rd.src, rd.j_off),
                                        rd.j_off)
                    min_p[rd.src] = min(min_p.get(rd.src, rd.p_off),
                                        rd.p_off)
                if cls == "gather":
                    emit("PV001", "warning", rd.src, call.name,
                         f"step {step.op} reads "
                         f"[{origin}, Ni{origin + rd.w_off:+d}) of a "
                         f"buffer resident over [0, Ni{res_hi:+d}): "
                         f"per-lane gather/clamp")
                    hint("layout_transform", call.name, rd.src,
                         (("origin", origin), ("width_off", rd.w_off)),
                         "re-lay the lane dim so the span is "
                         "statically resident (kills the per-lane "
                         "gather)")
                if cls == "strided":
                    emit("PV006", "warning", rd.src, call.name,
                         f"step {step.op} reads every "
                         f"{rd.i_stride}th lane element: strided "
                         f"access defeats contiguous vector loads")
                    hint("layout_transform", call.name, rd.src,
                         (("stride", rd.i_stride),),
                         "dimension-lifted transpose turns the "
                         "strided read into unit-stride lanes")
                    loaded[0] += 1.0 / rd.i_stride
                    loaded[1] += rd.w_off / rd.i_stride
                    tot_loaded[0] += 1.0 / rd.i_stride
                    tot_loaded[1] += rd.w_off / rd.i_stride
                    tot_unique[0] += 1.0 / rd.i_stride
                    tot_unique[1] += rd.w_off / rd.i_stride
                    continue
                loaded[0] += 1.0
                loaded[1] += rd.w_off
                tot_loaded[0] += 1.0
                tot_loaded[1] += rd.w_off
                groups.setdefault((rd.src, rd.j_off, rd.p_off),
                                  []).append((origin, rd.w_off, cls))
            unique = [0.0, 0.0]
            for (src, j_off, p_off), accs in groups.items():
                lo = min(o for o, _, _ in accs)
                hi = max(o + w for o, w, _ in accs)
                unique[0] += 1.0
                unique[1] += hi - lo
                tot_unique[0] += 1.0
                tot_unique[1] += hi - lo
                if len(accs) > 1:
                    hint("shift_reuse", call.name, src,
                         (("loads", len(accs)), ("span", hi - lo)),
                         "replace overlapping loads of one resident "
                         "row with one widened load plus in-register "
                         "shifts")
                if not any(o % LANE == 0 for o, _, c in accs
                           if c != "gather"):
                    origins = sorted(o for o, _, _ in accs)
                    emit("PV002", "warning", src, call.name,
                         f"step {step.op} row j{j_off:+d}: no read of "
                         f"this group is lane-aligned (origins "
                         f"{origins}) — every load crosses lanes")
                    hint("realign_origin", call.name, src,
                         (("origins", tuple(origins)),),
                         "re-origin the resident window so the group "
                         "gains an aligned anchor load")
            n_reads = int(round(loaded[0]))
            n_groups = len(groups)
            if n_reads > n_groups:
                ratio = _ratio(tuple(loaded), tuple(unique), ni)
                emit("PV005", "warning", step.op, call.name,
                     f"{n_reads} contiguous reads over {n_groups} "
                     f"resident row(s): overlapping shifted loads "
                     f"move {ratio:.2f}x the unique elements")
            if n_reads:
                steps_v.append(StepVec(
                    call.name, step.op, n_reads, n_groups,
                    tuple(loaded), tuple(unique),
                    _ratio(tuple(loaded), tuple(unique), ni)))
            # write sites: the produced row per target
            for targets in step.writes:
                for kind, tgt in targets:
                    if kind == "buf":
                        w = windows.get(tgt)
                        origin = step.out_col0 - (w.i_lo if w else 0)
                        res_hi = (w.i_hi - w.i_lo) if w else 0
                    else:
                        origin, res_hi = 0, step.out_w_off
                    cls = _classify(origin, res_hi, step.out_w_off, 1)
                    sites.append(AccessSite(
                        call.name, step.op, "write",
                        tgt if kind == "buf" else f"{kind}:{tgt}",
                        0, 0, origin, step.out_w_off, 1, cls))

        # window reuse distances
        for src, ispec in inputs.items():
            if src not in min_j:
                continue
            if ispec.plane:
                reuse = ispec.p_lead - min_p.get(src, 0) + 1
                windows_v.append(WindowVec(
                    call.name, src, ispec.p_stages, reuse,
                    ispec.p_stages - reuse, plane=True))
            elif ispec.stages > 1:
                reuse = ispec.lead - min_j[src] + 1
                windows_v.append(WindowVec(
                    call.name, src, ispec.stages, reuse,
                    ispec.stages - reuse))
        for name, w in windows.items():
            if name not in min_j:
                continue
            lead = max((call.steps[pi].lead
                        for pi in writers.get(name, ())), default=0)
            if w.plane:
                reuse = w.p_lead - min_p.get(name, 0) + 1
                windows_v.append(WindowVec(
                    call.name, name, w.p_stages, reuse,
                    w.p_stages - reuse, plane=True))
            else:
                reuse = lead - min_j[name] + 1
                windows_v.append(WindowVec(
                    call.name, name, w.stages, reuse,
                    w.stages - reuse))

        # accumulator layout: acc_rows folds across lanes every row
        for out in call.outputs:
            if out.kind == "acc_rows":
                emit("PV003", "warning", out.name, call.name,
                     "row-kept reduction emits one partial row per "
                     "grid step: the host folds across lanes for "
                     "every row")
                hint("acc_lane_block", call.name, out.name, (),
                     "block the accumulator over lanes so the "
                     "cross-lane fold happens once per block, not "
                     "per row")

        # lane occupancy (needs the concrete vector-dim size)
        if ni is not None:
            def occ(width, rows, var, pad=0):
                nonlocal occ_useful, occ_padded
                alloc = pad_to_lane(width + pad)
                useful, padded = width * rows, alloc * rows
                occ_useful += useful
                occ_padded += padded
                if padded and useful / padded < PV004_OCCUPANCY:
                    emit("PV004", "warning", var, call.name,
                         f"row width {width} occupies "
                         f"{useful / padded:.2f} of its lane-padded "
                         f"{alloc} elements: padding "
                         f"waste")
            for src, ispec in inputs.items():
                occ(ni + ispec.i_hi - ispec.i_lo,
                    ispec.p_stages if ispec.plane else ispec.stages,
                    src, pad=ispec.align_pad)
            for name, w in windows.items():
                occ(ni + w.i_hi - w.i_lo,
                    w.p_stages if w.plane else w.stages, name,
                    pad=w.align_pad)
            for a in call.accs:
                occ(ni + a.w_off, 1, a.name)
            for v in call.vloads:
                occ(ni + v.w_off, v.carry + 1, f"vec:{v.name}")

    order = {"error": 0, "warning": 1}
    diags.sort(key=lambda d: (order.get(d.severity, 2), d.nest, d.code))
    ratio = _ratio(tuple(tot_loaded), tuple(tot_unique), report_ni) \
        if tot_unique != [0.0, 0.0] else 1.0
    moved = needed = None
    if report_ni is not None and tot_unique != [0.0, 0.0]:
        moved = int(_aff_eval(tot_loaded, report_ni)) * int(dtype_bytes)
        needed = int(_aff_eval(tot_unique, report_ni)) * int(dtype_bytes)
    return VecReport(
        program=kplan.program,
        sites=tuple(sites),
        steps=tuple(steps_v),
        windows=tuple(windows_v),
        diagnostics=tuple(diags),
        hints=tuple(hints),
        redundant_load_ratio=ratio,
        lane_occupancy=(occ_useful / occ_padded
                        if occ_padded else None),
        bytes_moved=moved,
        bytes_needed=needed,
        ni=report_ni,
    )


# ---------------------------------------------------------------------------
# Plan annotation + auto-routing tiebreaker
# ---------------------------------------------------------------------------

def attach_layout_hints(kplan: KernelPlan) -> KernelPlan:
    """Return the plan with VecScan's advisory
    :class:`~repro_torch.core.plan.LayoutHint` records attached
    (``layout_hints`` is ``compare=False``, so equality, hashes and
    cache keys are unchanged; serialization carries the hints)."""
    rep = scan_plan(kplan)
    if not rep.hints:
        return kplan
    return dataclasses.replace(kplan, layout_hints=rep.hints)


def min_occupancy() -> float:
    """The auto-routing lane-occupancy floor
    (:data:`OCCUPANCY_ENV` env override, else
    :data:`DEFAULT_MIN_OCCUPANCY`)."""
    env = os.environ.get(OCCUPANCY_ENV)
    return float(env) if env else DEFAULT_MIN_OCCUPANCY


def auto_vec_reject(kplan: KernelPlan, sizes: dict, *,
                    dtype_bytes: int = 4) -> Optional[str]:
    """``backend="auto"`` tiebreaker: a reason string when the static
    vectorization model argues against routing this plan (with these
    concrete sizes) to the Pallas executor, else ``None``.

    Two gates, both size-dependent (the probe only consults this when
    ``dim_sizes`` resolve): lane occupancy below :func:`min_occupancy`
    (tiny vector dims waste most of every padded lane), and — only
    when :data:`AUTO_RATIO_ENV` is set — a redundant-load ratio above
    that ceiling."""
    rep = scan_plan(kplan, sizes=sizes, dtype_bytes=dtype_bytes)
    floor = min_occupancy()
    if rep.lane_occupancy is not None and rep.lane_occupancy < floor:
        return (f"lane occupancy {rep.lane_occupancy:.2f} below the "
                f"{floor:.2f} floor")
    env = os.environ.get(AUTO_RATIO_ENV)
    if env:
        cap = float(env)
        if rep.redundant_load_ratio > cap:
            return (f"redundant-load ratio "
                    f"{rep.redundant_load_ratio:.2f} above the "
                    f"{cap:.2f} ceiling")
    return None
