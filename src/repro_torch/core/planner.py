"""The planner: lower an HFAV storage plan to the declarative
:class:`~repro_torch.core.plan.KernelPlan` IR.

The port's counterpart of the planner half of
``repro.core.codegen_pallas`` (``plan_pallas``, ``_plan_nest``,
``PallasGenerated``), copied unchanged in what it decides, so the port
reproduces the JAX package's golden plans.  The names ``plan_pallas``
and ``PallasUnsupported`` are kept because the goldens and the docs use
them; the plans it emits run on any registered interpreter of the port
(:mod:`repro_torch.core.interpreters`), the CUDA stencil kernel among
them.

* every top-level nest whose groups iterate the row/vector ``(j, i)``
  plane becomes one :class:`~repro_torch.core.plan.CallPlan`; the nest's
  outer loop identifiers are flattened one-to-one onto leading grid
  dims, each covering the union of canonical ranges its groups and
  plane windows need;
* streamed inputs read at non-zero offsets in the *plane dim* get a
  multi-plane window plan; variables produced in the nest and read back
  at plane offsets get a producer plane window;
* reductions become accumulator plans (carried, kept-prefix or
  row-kept), 0-dim kernels become host steps, ``full`` variables
  crossing a split are materialized between calls.

Every restriction check is delegated to the ``require_*`` validate pass
in :mod:`repro_torch.core.plan`; the finished plan is re-checked by
:meth:`KernelPlan.validate` and annotated with VecScan's advisory
layout hints before it leaves this module.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

from .dataflow import Group
from .infer import IDAG
from .inest import walk_bodies
from .plan import (AccPlan, AxiomPlan, CallPlan, GridDim, HostStepPlan,
                   InputPlan, KernelPlan, OutputPlan, PallasUnsupported,
                   ReadPlan, StepPlan, WindowPlan, acc_init_wrap,
                   require_full_outer_iteration,
                   require_host_group_0dim, require_host_orderable,
                   require_host_read_no_offset, require_kept_prefix,
                   require_loop_order, require_matching_producer_extent,
                   require_materialized_extents, require_nest_order,
                   require_nest_outputs, require_no_nonplane_lead,
                   require_offset_in_window_dims, require_output_row_span,
                   require_reduction_iterates_vector,
                   require_reduction_result_kind, require_representable_read,
                   require_representable_write, require_row_contraction,
                   require_row_kept_vector_only, require_same_step_position,
                   require_scalar_acc_stream, require_streamed_suffix)
from .reuse import StoragePlan, VarPlan, dim_window, produced_window
from .terms import Term

__all__ = ["PallasGenerated", "PallasUnsupported", "plan_pallas"]


def _env_name(vp: VarPlan) -> str:
    if vp.kind == "external_in":
        return vp.var.key.ref.name
    return vp.name


class _FnTable:
    """Per-call kernel function table: steps reference callables by
    index so the plan IR stays declarative (and comparable)."""

    def __init__(self):
        self.fns: list[Callable] = []
        self._idx: dict[int, int] = {}

    def add(self, fn: Callable) -> int:
        k = id(fn)
        if k not in self._idx:
            self._idx[k] = len(self.fns)
            self.fns.append(fn)
        return self._idx[k]


def _host_step(plan: StoragePlan, g: Group, fns: _FnTable) -> HostStepPlan:
    require_host_group_0dim(str(g), g.dims)
    assert g.rule is not None and g.rule.fn is not None
    reads = []
    for _, key, offs in g.reads:
        if any(o != 0 for o in offs.values()):
            require_host_read_no_offset(str(g), plan.vars[key].name)
        reads.append(_env_name(plan.vars[key]))
    writes = [_env_name(plan.vars[key]) for _, key in g.writes]
    return HostStepPlan(g.name, fns.add(g.rule.fn), tuple(reads),
                        tuple(writes))


def _plan_nest(plan: StoragePlan, idag: IDAG, nest_idx: int) -> CallPlan:
    """The grid mapper: lower one top-level fused nest to a CallPlan.

    Outer loop identifiers are flattened onto leading grid dims (each
    covering the union of canonical ranges its groups and plane windows
    need — warm-up tiles and producer plane leads included); the row
    identifier becomes the final (fastest) grid dim; the innermost
    identifier is vectorized across lanes.  Restriction checks are the
    ``require_*`` sites of :mod:`repro.core.plan` (table in
    docs/BACKENDS.md)."""
    schedule = plan.schedule
    program = schedule.program
    dag = schedule.dag
    inner = program.loop_order[-1]
    jdim = program.loop_order[-2]
    outer_dims = program.loop_order[:-2]
    # the plane dim: the only outer dim in which variables may be read
    # at non-zero (halo) offsets, via multi-plane VMEM windows
    pdim = outer_dims[-1] if outer_dims else None
    nest_of_gid = plan.nest_of_gid
    np_ = plan.nests[nest_idx]
    by_id = {g.gid: g for g in dag.groups}
    goal_of_base = {t.base(): goal for t, goal in idag.goal_of.items()}
    axiom_exts = {t.base(): ax.extents for t, ax in idag.axiom_of.items()}
    name = f"{program.name}_n{nest_idx}"
    fns = _FnTable()

    ordered: list[int] = []
    for body in walk_bodies(schedule.nests[nest_idx]):
        ordered.extend(body.gids)
    kernels = [by_id[gid] for gid in ordered if by_id[gid].kind == "kernel"]
    grid = [g for g in kernels if jdim in g.dims]
    grid_gids = {g.gid for g in grid}

    host_pre: list[HostStepPlan] = []
    host_post: list[HostStepPlan] = []
    for g in kernels:
        if jdim in g.dims:
            continue
        if not grid or dag.dataflow_le({g.gid}, grid_gids):
            host_pre.append(_host_step(plan, g, fns))
        elif dag.dataflow_le(grid_gids, {g.gid}):
            host_post.append(_host_step(plan, g, fns))
        else:
            require_host_orderable(str(g), jdim)
    if not grid:
        return CallPlan(name, (), inner, host_pre=tuple(host_pre),
                        host_post=tuple(host_post), fns=tuple(fns.fns))

    # per-outer-dim canonical grid ranges (the outer analogue of
    # x_lo/x_hi_off): every group and plane window contributes
    o_los: dict[str, list[int]] = {d: [] for d in outer_dims}
    o_his: dict[str, list[int]] = {d: [] for d in outer_dims}

    # ---- streamed inputs --------------------------------------------------
    in_specs: list[InputPlan] = []
    input_src: dict[Term, str] = {}
    plane_inputs: set[Term] = set()
    x_los: list[int] = []
    x_his: list[int] = []

    def add_input(key: Term) -> None:
        vp = plan.vars[key]
        v = vp.var
        iname = _env_name(vp)
        if not v.dims:
            in_specs.append(InputPlan(iname, scalar=True))
            input_src[key] = f"scalar:{iname}"
            return
        require_streamed_suffix(iname, tuple(v.dims),
                                tuple(program.loop_order))
        rank = len(v.dims)
        # the window shape *and* the grid ranges below both come from
        # the same extents — the array's own origin frame (axiom extents
        # for external inputs, the variable extent for materialized
        # intermediates); mixing frames misaligns the fetched window
        exts = axiom_exts[v.key] if vp.kind == "external_in" else v.extent
        ej = exts.get(jdim)
        ei = exts.get(inner)
        j_lo, j_hi = (ej.lo, ej.hi) if ej is not None else (0, 0)
        i_lo, i_hi = (ei.lo, ei.hi) if ei is not None else (0, 0)
        lead, stages, _ = dim_window(np_, v, jdim, within=grid_gids)
        p_lead, p_stages = 0, 1
        if pdim is not None and pdim in v.dims:
            p_lead, p_stages, p_positions = dim_window(
                np_, v, pdim, within=grid_gids)
            if not any(p != 0 for p in p_positions):
                p_lead, p_stages = 0, 1  # no halo: plain row streaming
        outer_los: list[int] = []
        outer_his: list[int] = []
        for d in v.dims[:-2]:
            e = exts.get(d)
            outer_los.append(e.lo if e is not None else 0)
            outer_his.append(e.hi if e is not None else 0)
        in_specs.append(InputPlan(iname, stages, lead, j_lo, j_hi, i_lo, i_hi,
                                  n_outer=rank - 2, p_stages=p_stages,
                                  p_lead=p_lead, outer_los=tuple(outer_los),
                                  outer_his=tuple(outer_his)))
        input_src[key] = f"in_{iname}"
        if ej is not None:
            x_los.append(ej.lo - lead)
            x_his.append(ej.hi - lead)
        if p_stages > 1 or p_lead:
            plane_inputs.add(key)
            # warm-up tiles: the plane window must have streamed every
            # plane a tile reads before that tile computes
            ep = exts.get(pdim)
            p_lo, p_hi = (ep.lo, ep.hi) if ep is not None else (0, 0)
            o_los[pdim].append(p_lo - p_lead)
            o_his[pdim].append(p_hi - p_lead)

    for g in grid:
        for _, key, _offs in g.reads:
            if key in input_src:
                continue
            vp = plan.vars[key]
            if vp.kind == "external_in":
                add_input(key)
            elif vp.kind in ("full", "acc", "scalar"):
                p = vp.var.producer
                assert p is not None
                if p.gid in grid_gids:
                    continue  # produced in-grid: local/windowed (below)
                p_nest = nest_of_gid.get(p.gid)
                if p_nest is not None and p_nest > nest_idx:
                    require_nest_order(vp.name)
                if vp.kind == "acc" and vp.var.dims:
                    require_scalar_acc_stream(vp.name, tuple(vp.var.dims))
                add_input(key)

    # ---- VMEM windows for in-nest produced variables ----------------------
    windows: list[WindowPlan] = []
    accs: list[AccPlan] = []
    steps: list[StepPlan] = []
    outputs: list[OutputPlan] = []
    seen_bufs: set[str] = set()

    for key, vp in plan.vars.items():
        if vp.kind == "rolling" and vp.var.producer is not None \
                and vp.var.producer.gid in grid_gids:
            require_row_contraction(vp.name, vp.contraction_dim, jdim)
            windows.append(WindowPlan(f"b_{vp.name}", vp.stages,
                                      vp.i_lo, vp.i_hi))
            seen_bufs.add(f"b_{vp.name}")

    # A variable produced in this grid and read back at a *plane* offset
    # by the same grid gets a producer plane window: the producer runs
    # its plane-dim lead ahead of the outer grid and whole planes stay
    # resident (the outer-dim analogue of the rolling row window).  A
    # variable read back at a *row* offset only keeps the rolling-window
    # plan sized by the consumer-position spread.
    cross_row_buf: dict[Term, str] = {}
    plane_buf: dict[Term, str] = {}
    for key, vp in plan.vars.items():
        if vp.kind not in ("full", "external_out"):
            continue
        p = vp.var.producer
        if p is None or p.gid not in grid_gids or p.is_reduction:
            continue
        wname = f"b_{vp.name}"
        if pdim is not None and pdim in vp.var.dims:
            p_lead_p, p_stages, p_positions = produced_window(
                np_, vp.var, pdim, within=grid_gids)
            if p_positions and any(pos != p_lead_p for pos in p_positions):
                ej = vp.var.extent.get(jdim)
                j_lo, j_hi = (ej.lo, ej.hi) if ej is not None else (0, 0)
                windows.append(WindowPlan(
                    wname, 1, vp.i_lo, vp.i_hi, p_stages=p_stages,
                    p_lead=p_lead_p, j_lo=j_lo, j_hi=j_hi))
                plane_buf[key] = wname
                continue
        p_lead_j, j_stages, positions = produced_window(
            np_, vp.var, jdim, within=grid_gids)
        if positions and any(pos != p_lead_j for pos in positions):
            windows.append(WindowPlan(wname, j_stages, vp.i_lo, vp.i_hi))
            cross_row_buf[key] = wname

    def check_offsets(v: str, offs_by_dim, windowed: bool) -> None:
        """Offsets live in the row/vector dims, or the plane dim when a
        plane window (streamed or produced) serves them."""
        for d, o in offs_by_dim.items():
            if d in (inner, jdim) or o == 0:
                continue
            if d == pdim and windowed:
                continue
            require_offset_in_window_dims(v, d, o, pdim, jdim, inner)

    def outer_extents(exts) -> tuple[tuple[int, ...], tuple[int, ...]]:
        los, his = [], []
        for d in outer_dims:
            e = exts.get(d)
            los.append(e.lo if e is not None else 0)
            his.append(e.hi if e is not None else 0)
        return tuple(los), tuple(his)

    # ---- fused kernel steps ----------------------------------------------
    for g in grid:
        assert g.rule is not None and g.rule.fn is not None
        missing = [d for d in outer_dims if d not in g.dims]
        if missing:
            require_full_outer_iteration(str(g), missing,
                                         tuple(program.loop_order))
        outer_leads = tuple(np_.lead(g.gid, d) for d in outer_dims)
        for di, d in enumerate(outer_dims):
            if outer_leads[di] and d != pdim:
                require_no_nonplane_lead(str(g), d, outer_leads[di])
            e = g.extent.get(d)
            o_los[d].append((e.lo if e is not None else 0) - outer_leads[di])
            o_his[d].append((e.hi if e is not None else 0) - outer_leads[di])
        lead = np_.lead(g.gid, jdim)
        p_pos0 = outer_leads[-1] if outer_dims else 0
        ext_j = g.extent.get(jdim)
        if ext_j is not None:
            x_los.append(ext_j.lo - lead)
            x_his.append(ext_j.hi - lead)
        c_ilo = g.extent[inner].lo if inner in g.extent else 0
        c_w = (g.extent[inner].hi - g.extent[inner].lo) \
            if inner in g.extent else 0

        reads = []
        for _, key, offs in g.reads:
            vp = plan.vars[key]
            src = input_src.get(key)
            check_offsets(vp.name, offs,
                          windowed=src is not None or key in plane_buf)
            oj = offs.get(jdim, 0)
            oi = offs.get(inner, 0)
            op = offs.get(pdim, 0) if pdim is not None else 0
            p_pos = p_pos0 + op  # total plane position of this read
            if src is not None:
                if src.startswith("scalar:"):
                    reads.append(ReadPlan(src, 0, 0, 0))
                else:
                    if p_pos and key not in plane_inputs:
                        # a plane read of an input whose window was
                        # planned rowwise cannot happen: dim_window saw
                        # the same consumer positions
                        raise AssertionError(
                            f"unplanned plane read of {vp.name}")
                    reads.append(ReadPlan(src, lead + oj, c_ilo + oi, c_w,
                                          p_off=p_pos))
            elif key in plane_buf:
                reads.append(ReadPlan(plane_buf[key], lead + oj, c_ilo + oi,
                                      c_w, p_off=p_pos))
            elif vp.kind == "rolling":
                reads.append(ReadPlan(f"b_{vp.name}", lead + oj,
                                      c_ilo + oi, c_w))
            elif key in cross_row_buf:
                # materialized in-nest AND read at a row offset: served
                # from the rolling window planned above
                reads.append(ReadPlan(cross_row_buf[key], lead + oj,
                                      c_ilo + oi, c_w))
            elif vp.kind in ("row", "full", "scalar", "external_out"):
                # produced by this nest's grid: visible as a same-step row
                p = vp.var.producer
                assert p is not None
                if vp.kind != "row":
                    require_same_step_position(vp.name, vp.kind, lead + oj,
                                               np_.lead(p.gid, jdim))
                p_ilo = p.extent[inner].lo if inner in p.extent else 0
                # a same-step row: its row is the consumer's (and so
                # the producer's) lead
                reads.append(
                    ReadPlan(f"local:{vp.name}", lead + oj,
                             (c_ilo + oi) - p_ilo, c_w))
            else:
                require_representable_read(vp.name, vp.kind)

        if g.is_reduction:
            (_, okey), = g.writes
            ovp = plan.vars[okey]
            # 'acc': consumed downstream (streamed as a scalar input);
            # 'external_out': the reduction result is itself a goal.
            require_reduction_result_kind(ovp.name, ovp.kind)
            if inner not in g.dims:
                require_reduction_iterates_vector(str(g))
            kept = tuple(ovp.var.dims)
            goal = goal_of_base.get(okey)
            gexts = goal.extents if goal is not None else ovp.var.extent
            valid = (ext_j.lo, ext_j.hi) if ext_j is not None else (0, 0)
            valid_outer = tuple(
                ((g.extent[d].lo, g.extent[d].hi) if d in g.extent
                 else (0, 0))
                for d in outer_dims
            )
            if jdim in kept:
                # row-kept reduction: each grid step's combine is final
                # for its (outer..., j) point — emit one partial-
                # accumulator row per step (identity-filled outside the
                # computed span) and lane-reduce on the host.
                require_row_kept_vector_only(ovp.name, jdim,
                                             tuple(g.reduced_dims), inner)
                require_output_row_span(ovp.name, c_ilo, c_ilo + c_w,
                                        what="partial-accumulator row")
                init = ovp.acc_init
                fn_with_init = acc_init_wrap(g.rule.fn, init)
                glos, ghis = outer_extents(gexts)
                gj = gexts.get(jdim)
                steps.append(StepPlan(g.name, fns.add(fn_with_init),
                                      tuple(reads),
                                      ((("out", len(outputs)),),),
                                      lead, c_ilo, c_w))
                outputs.append(OutputPlan(
                    _env_name(ovp), kind="acc_rows", lead=lead,
                    j_lo=(gj.lo if gj is not None else 0),
                    j_hi=(gj.hi if gj is not None else 0),
                    outer_lo=glos, outer_hi=ghis, outer_lead=outer_leads,
                    fill=init, reduce_idx=fns.add(g.rule.fn),
                    reduce_init=init,
                ))
                continue
            kept_outer = tuple(d for d in kept if d != inner)
            require_kept_prefix(ovp.name, kept_outer, tuple(outer_dims))
            n_kept = len(kept_outer)
            acc = AccPlan(f"a_{ovp.name}", c_w, ovp.acc_init, n_kept=n_kept)
            accs.append(acc)
            steps.append(StepPlan(g.name, fns.add(g.rule.fn), tuple(reads),
                                  (), lead, c_ilo, c_w, acc=acc.name,
                                  valid=valid, valid_outer=valid_outer))
            glos, ghis = outer_extents(gexts)
            outputs.append(OutputPlan(
                _env_name(ovp), kind="acc", lead=lead,
                outer_lo=glos, outer_hi=ghis, outer_lead=outer_leads,
                acc=acc.name, n_kept=n_kept,
                reduce_idx=(fns.add(g.rule.fn)
                            if inner in ovp.acc_reduced else None),
                reduce_init=ovp.acc_init,
            ))
            continue

        writes = []
        for _, key in g.writes:
            vp = plan.vars[key]
            v = vp.var
            consumed_in_grid = any(
                u.group.gid in grid_gids for u in v.consumers)
            targets: list[tuple[str, object]] = []
            if vp.kind == "rolling":
                assert f"b_{vp.name}" in seen_bufs, \
                    f"unplanned rolling buffer {vp.name}"
                targets.append(("buf", f"b_{vp.name}"))
            elif vp.kind == "row":
                targets.append(("local", vp.name))
            elif vp.kind in ("external_out", "full"):
                materialize = vp.kind == "external_out" or v.is_output \
                    or any(u.group.gid not in grid_gids
                           for u in v.consumers)
                if materialize:
                    if vp.kind == "external_out":
                        require_output_row_span(vp.name, c_ilo, c_ilo + c_w)
                        goal = goal_of_base.get(key)
                        gexts = goal.extents if goal is not None else {}
                        glos, ghis = outer_extents(gexts)
                        gj = gexts.get(jdim)
                        outputs.append(OutputPlan(
                            _env_name(vp), kind="external", lead=lead,
                            j_lo=(gj.lo if gj is not None else 0),
                            j_hi=(gj.hi if gj is not None else 0),
                            outer_lo=glos, outer_hi=ghis,
                            outer_lead=outer_leads,
                        ))
                    else:
                        ej = v.extent.get(jdim)
                        ei = v.extent.get(inner)
                        if ej is None or ei is None:
                            require_materialized_extents(vp.name)
                        if (inner in g.extent and g.extent[inner] != ei) or \
                                (jdim in g.extent and g.extent[jdim] != ej):
                            require_matching_producer_extent(vp.name)
                        require_output_row_span(vp.name, ei.lo, ei.hi)
                        vlos, vhis = outer_extents(v.extent)
                        outputs.append(OutputPlan(
                            _env_name(vp), kind="full", lead=lead,
                            j_lo=ej.lo, j_hi=ej.hi, i_lo=ei.lo, i_hi=ei.hi,
                            outer_lo=vlos, outer_hi=vhis,
                            outer_lead=outer_leads,
                        ))
                    targets.append(("out", len(outputs) - 1))
                if key in plane_buf:
                    # in-nest plane-offset consumers read resident planes
                    targets.append(("buf", plane_buf[key]))
                elif key in cross_row_buf:
                    # ...and earlier-row consumers the rolling window
                    targets.append(("buf", cross_row_buf[key]))
                elif consumed_in_grid:
                    # same-step consumers within this nest
                    targets.append(("local", vp.name))
            else:
                require_representable_write(vp.name, vp.kind)
            writes.append(tuple(targets))
        steps.append(StepPlan(g.name, fns.add(g.rule.fn), tuple(reads),
                              tuple(writes), lead, c_ilo, c_w))

    if not outputs:
        require_nest_outputs(nest_idx)
    grid_dims = tuple(
        GridDim(d, min(o_los[d]) if o_los[d] else 0,
                max(o_his[d]) if o_his[d] else 0)
        for d in outer_dims
    ) + (GridDim(jdim, min(x_los) if x_los else 0,
                 max(x_his) if x_his else 0),)
    return CallPlan(
        name=name,
        grid=grid_dims,
        vec_dim=inner,
        inputs=tuple(in_specs),
        windows=tuple(windows),
        accs=tuple(accs),
        steps=tuple(steps),
        outputs=tuple(outputs),
        host_pre=tuple(host_pre),
        host_post=tuple(host_post),
        fns=tuple(fns.fns),
    )


def plan_pallas(plan: StoragePlan, idag: IDAG) -> KernelPlan:
    """Lower a storage plan to a validated :class:`KernelPlan` — the
    pure planner half of the Pallas backend (program + schedule + reuse
    metadata in, declarative IR out; no JAX tracing, no execution).
    Raises :class:`PallasUnsupported` for schedules outside the
    interpreter's shape."""
    program = plan.schedule.program
    dag = plan.schedule.dag
    require_loop_order(tuple(program.loop_order))
    dim_sym = {d: f"N{d}" for d in program.loop_order}
    axiom_ext = {t.base(): ax.extents for t, ax in idag.axiom_of.items()}
    for exts in axiom_ext.values():
        for d, e in exts.items():
            dim_sym[d] = e.size
    axioms = tuple(sorted(
        (AxiomPlan(key.ref.name, tuple(key.dims),
                   tuple((d, exts[d].size, exts[d].lo, exts[d].hi)
                         for d in key.dims if d in exts))
         for key, exts in axiom_ext.items()),
        key=lambda a: (a.array, a.dims)))
    goal_outputs = tuple(
        (goal.store_as or dag.variables[t.base()].name,
         dag.variables[t.base()].name)
        for t, goal in idag.goal_of.items()
    )
    calls = tuple(_plan_nest(plan, idag, k) for k in range(len(plan.nests)))
    kplan = KernelPlan(
        program=program.name,
        loop_order=tuple(program.loop_order),
        dim_sizes=tuple(sorted(dim_sym.items())),
        axioms=axioms,
        goal_outputs=goal_outputs,
        calls=calls,
    )
    kplan = kplan.validate()
    # annotate with the vectorization analyzer's advisory layout hints
    # (compare=False: identity, hashes and cache keys are unchanged;
    # serialization carries them into the goldens).  Imported lazily —
    # vecscan walks the plan IR this module produces.
    from .vecscan import attach_layout_hints
    return attach_layout_hints(kplan)


@dataclass
class PallasGenerated:
    """A compiled program: the declarative :class:`KernelPlan` plus the
    host callable executing it.

    ``plan`` is the analysis-side :class:`StoragePlan` the compilation
    ran.  ``interpreter`` names the registered plan interpreter
    (:mod:`repro_torch.core.interpreters`) whose ``build_call``
    executes ``kernel_plan`` inside ``fn``, and ``device`` the torch
    device ``fn`` runs on.  ``base_plan`` is the plan before the
    LayoutApply pass (the one the on-disk plan cache stores),
    ``layout_result`` what the pass did (``None`` when it did not run)
    and ``vec_report`` the vectorization report a compilation asked
    for.  ``batch_fn``, where the interpreter declares a batched
    ``build_call``, is ``fn`` over a leading batch axis of every array
    (one host half and one launch of each call for the batch), else
    ``None``."""

    kernel_plan: KernelPlan
    fn: Callable
    plan: Optional[StoragePlan] = None
    interpreter: str = "cuda"
    device: Optional[object] = None
    base_plan: Optional[KernelPlan] = None
    layout_result: Optional[object] = None
    vec_report: Optional[object] = None
    batch_fn: Optional[Callable] = None

    @property
    def calls(self) -> tuple[CallPlan, ...]:
        """The plan's stencil calls (host-only nests excluded)."""
        return tuple(c for c in self.kernel_plan.calls if c.has_grid)

    @property
    def call(self) -> CallPlan:
        """The first (often only) stencil call's plan."""
        return self.calls[0]

    @property
    def schedule(self):
        """The fused schedule this execution realizes."""
        if self.plan is None:
            raise ValueError("this PallasGenerated was built from a bare "
                             "KernelPlan (e.g. one loaded from the on-disk "
                             "plan cache): no StoragePlan/schedule exists")
        return self.plan.schedule
