"""Reuse analysis, software-pipeline leads, and storage contraction
(Sections 3.4 & 3.5).

For every intermediate variable inside a fused nest we compute:

* the *reuse order* — the Hamiltonian path of Fig. 8, i.e. the order in
  which a fixed storage location is touched by the stencil references as
  the iteration progresses (descending lexicographic offsets in loop
  order);
* per-group *leads* for non-innermost dimensions — how far ahead of the
  canonical iteration point each producer must run so that consumers
  reading positive offsets see initialized data (the paper's software
  pipeline / prologue priming);
* the *contraction* of intermediate storage to rolling buffers whose stage
  count is the reuse distance in the outermost varying dimension plus one
  (Fig. 9a/9b), with rows padded for lane-aligned vectorization (Fig. 9c —
  on TPU the 'vector length' is the 128-wide lane tile; the pure-JAX
  backend vectorizes whole rows).
"""
from __future__ import annotations

from dataclasses import dataclass, field

from .dataflow import Var
from .fusion import FusedSchedule
from .inest import Node, walk_bodies
from .terms import Term


# ---------------------------------------------------------------------------
# Reuse order (Fig. 8)
# ---------------------------------------------------------------------------

def reuse_order(var_dims: tuple[str, ...], offsets: set[tuple[int, ...]],
                loop_order: tuple[str, ...]) -> list[tuple[int, ...]]:
    """Order references by first-touch time of a fixed location.

    With a linear progression in ``loop_order`` a location ``p`` is read by
    reference offset ``o`` at iteration ``p - o``; larger offsets touch it
    earlier.  Sorting descending-lexicographically (outermost dimension
    most significant) yields the Hamiltonian reuse path.
    """
    dim_pos = [var_dims.index(d) for d in loop_order if d in var_dims]

    def key(off: tuple[int, ...]):
        return tuple(-off[p] for p in dim_pos)

    return sorted(offsets, key=key)


def reuse_graph(var_dims, offsets, loop_order):
    """The explicit 3-step construction of Section 3.5: vertices per
    reference, edges a->b when a touches before b, longest path = the
    Hamiltonian reuse path.  Used by tests to cross-check ``reuse_order``."""
    order = reuse_order(var_dims, offsets, loop_order)
    verts = list(offsets)
    edges = {
        (a, b)
        for a in verts
        for b in verts
        if a != b and order.index(a) < order.index(b)
    }
    # longest path in a transitive tournament DAG == topological order.
    return verts, edges, order


# ---------------------------------------------------------------------------
# Plans
# ---------------------------------------------------------------------------

@dataclass
class VarPlan:
    var: Var
    kind: str  # external_in | external_out | full | rolling | row | scalar
    nest_index: int | None = None  # top-level nest owning its lifetime
    contraction_dim: str | None = None
    stages: int = 1
    # Row (innermost-dim) halo coverage relative to the size symbol:
    # the materialized row spans [i_lo, N_i + i_hi).
    i_lo: int = 0
    i_hi: int = 0
    reuse_path: list[tuple[int, ...]] = field(default_factory=list)
    # Reduction accumulators ('acc' kind): the combine identity and the
    # dims folded away — backends use these to stage the paper's
    # init/combine/finalize triple (vector partial accumulator + lane
    # reduction when the innermost dim is reduced).
    acc_init: float = 0.0
    acc_reduced: tuple[str, ...] = ()

    @property
    def name(self) -> str:
        return self.var.name


@dataclass
class NestPlan:
    node: Node
    gids: set[int]
    # gid -> dim -> lead (iterations ahead of the canonical point)
    leads: dict[int, dict[str, int]] = field(default_factory=dict)

    def lead(self, gid: int, dim: str) -> int:
        return self.leads.get(gid, {}).get(dim, 0)


@dataclass
class StoragePlan:
    schedule: FusedSchedule
    vars: dict[Term, VarPlan] = field(default_factory=dict)
    nests: list[NestPlan] = field(default_factory=list)
    # gid -> index into ``nests`` (which top-level nest owns each group);
    # the backends' grid mappers key scheduling decisions off this.
    nest_of_gid: dict[int, int] = field(default_factory=dict)

    def plan_of(self, key: Term) -> VarPlan:
        return self.vars[key]

    def summary(self) -> str:
        lines = []
        for p in self.vars.values():
            extra = ""
            if p.kind == "rolling":
                extra = f" dim={p.contraction_dim} stages={p.stages}"
            lines.append(f"{p.name}: {p.kind}{extra} row=[{p.i_lo},{p.i_hi}]")
        return "\n".join(sorted(lines))


def _nest_of(schedule: FusedSchedule) -> list[NestPlan]:
    plans = []
    for node in schedule.nests:
        gids = node.groups()
        plans.append(NestPlan(node, gids))
    return plans


def _innermost(schedule: FusedSchedule) -> str:
    return schedule.program.loop_order[-1]


def consumer_positions(np_: NestPlan, v: Var, dim: str,
                       within: set[int] | None = None) -> list[int]:
    """Positions (consumer lead + read offset) at which ``v`` is read
    along ``dim``, relative to the canonical iteration point.

    This is the schedule metadata the backends' grid mappers share with
    the contraction pass: the spread of these positions against the
    producer's lead determines rolling-window/streaming-window stage
    counts.  ``within`` restricts to consumers among those gids (e.g.
    only the groups mapped onto one stencil call's grid)."""
    if dim not in v.dims:
        return []
    di = v.dims.index(dim)
    out: list[int] = []
    for use in v.consumers:
        if within is not None and use.group.gid not in within:
            continue
        c_lead = np_.lead(use.group.gid, dim)
        for offs in use.offsets:
            out.append(c_lead + offs[di])
    return out


def window_stages(lead: int, positions: list[int]) -> int:
    """Rows a rolling/streaming window must keep: the producer writes at
    ``lead`` and the oldest consumer position (from
    :func:`consumer_positions`) bounds the reuse distance (Fig. 9a/9b:
    stages = reuse distance + 1)."""
    oldest = min(positions) if positions else lead
    return max(1, lead - min(oldest, lead) + 1)


def dim_window(np_: NestPlan, v: Var, dim: str,
               within: set[int] | None = None) -> tuple[int, int, list[int]]:
    """``(lead, stages, positions)`` of the window ``v`` needs along
    ``dim`` — the per-dimension form of the Fig. 9a/9b sizing rule.

    ``lead`` is how far ahead of the canonical point the stream must run
    so the newest consumer position is initialized (floored at 0: a
    stream never runs behind), and ``stages`` spans back to the oldest
    consumer position.  The same rule sizes row windows (``dim`` = the
    row identifier) and the plane windows carried across the outer grid
    for outer-dim stencil halos (``dim`` = an outer identifier)."""
    positions = consumer_positions(np_, v, dim, within)
    lead = max(0, max(positions)) if positions else 0
    return lead, window_stages(lead, positions), positions


def produced_window(np_: NestPlan, v: Var, dim: str,
                    within: set[int] | None = None
                    ) -> tuple[int, int, list[int]]:
    """``(lead, stages, positions)`` of the window a *produced* variable
    needs along ``dim`` — the producer-side companion of
    :func:`dim_window`.

    Where :func:`dim_window` sizes the window of a *streamed* input
    (whose stream lead floats to the newest consumer position), a
    produced variable's write position is pinned to its producer's
    software-pipeline lead in ``dim`` (from :func:`_compute_leads`), so
    the window must span from that lead back to the oldest consumer
    position.  The same rule sizes cross-row rolling windows (``dim`` =
    the row identifier) and producer plane windows carried across the
    outer grid (``dim`` = the plane identifier)."""
    assert v.producer is not None
    lead = np_.lead(v.producer.gid, dim)
    positions = consumer_positions(np_, v, dim, within)
    return lead, window_stages(lead, positions), positions


def _compute_leads(schedule: FusedSchedule, np_: NestPlan) -> None:
    """lead_P(d) >= lead_C(d) + max read offset in d, minimized, floored at
    0 per nest (longest-path over the nest's internal dataflow edges)."""
    dag = schedule.dag
    inner = _innermost(schedule)
    by_id = {g.gid: g for g in dag.groups}
    gids = np_.gids
    order = [g.gid for g in dag.topo_order() if g.gid in gids]
    lead: dict[int, dict[str, int]] = {gid: {} for gid in gids}
    for gid in reversed(order):
        g = by_id[gid]
        for _, base in g.writes:
            v = dag.variables[base]
            for use in v.consumers:
                c = use.group
                if c.gid not in gids:
                    continue
                for offs in use.offsets:
                    for di, d in enumerate(v.dims):
                        if d == inner:
                            continue  # row halo handles innermost offsets
                        need = lead[c.gid].get(d, 0) + offs[di]
                        if need > lead[gid].get(d, 0):
                            lead[gid][d] = need
    np_.leads = lead


def analyze_storage(schedule: FusedSchedule) -> StoragePlan:
    dag = schedule.dag
    program = schedule.program
    inner = _innermost(schedule)
    plan = StoragePlan(schedule)
    plan.nests = _nest_of(schedule)
    for np_ in plan.nests:
        _compute_leads(schedule, np_)

    nest_of_gid: dict[int, int] = {}
    for k, np_ in enumerate(plan.nests):
        for gid in np_.gids:
            nest_of_gid[gid] = k
    plan.nest_of_gid = nest_of_gid
    body_of_gid: dict[int, int] = {}
    bid = 0
    for np_ in plan.nests:
        for body in walk_bodies(np_.node):
            for gid in body.gids:
                body_of_gid[gid] = bid
            bid += 1

    for key, v in dag.variables.items():
        offsets: set[tuple[int, ...]] = set()
        for use in v.consumers:
            offsets |= use.offsets
        path = reuse_order(v.dims, offsets, program.loop_order) if offsets else []

        # Row halo (innermost dimension coverage).
        i_lo = i_hi = 0
        if inner in v.dims and inner in v.extent:
            i_lo, i_hi = v.extent[inner].lo, v.extent[inner].hi

        prod_nest = nest_of_gid.get(v.producer.gid) if v.producer else None
        cons_nests = {nest_of_gid[u.group.gid] for u in v.consumers if u.group.gid in nest_of_gid}

        if v.is_input:
            kind, nest_index = "external_in", None
        elif v.is_output:
            kind, nest_index = "external_out", prod_nest
        elif v.producer is not None and v.producer.is_reduction:
            kind, nest_index = "acc", prod_nest
        elif prod_nest is None or (cons_nests and cons_nests != {prod_nest}):
            kind, nest_index = "full", None  # crosses a split: materialize
        else:
            outer = [d for d in v.dims if d != inner]
            np_ = plan.nests[prod_nest]
            di_of = {d: v.dims.index(d) for d in outer}
            p_leads = {d: np_.lead(v.producer.gid, d) for d in outer}
            active: set[str] = set()
            for use in v.consumers:
                for d in outer:
                    if np_.lead(use.group.gid, d) != p_leads[d]:
                        active.add(d)
                for offs in use.offsets:
                    for d in outer:
                        if offs[di_of[d]] != 0:
                            active.add(d)
            same_body = all(
                body_of_gid.get(u.group.gid) == body_of_gid.get(v.producer.gid)
                for u in v.consumers
            )
            prod_outer = [d for d in v.producer.dims if d != inner]
            if not v.dims:
                kind, nest_index = "scalar", prod_nest
            elif not active and (same_body or not prod_outer):
                # same-iteration local / broadcast row from an enclosing
                # scope — no carried storage at all.
                kind, nest_index = "row", prod_nest
            elif not outer or active - {outer[-1]}:
                # activity in a non-adjacent outer dimension: contraction
                # would need multi-row planes; materialize in full.
                kind, nest_index = "full", None
            else:
                kind, nest_index = "rolling", prod_nest
        vp = VarPlan(v, kind, nest_index, i_lo=i_lo, i_hi=i_hi, reuse_path=path)
        if v.producer is not None and v.producer.is_reduction:
            # accumulator metadata travels with every reduction result —
            # including one stored straight to a goal (kind external_out)
            g = v.producer
            vp.acc_init = g.rule.init if g.rule is not None else 0.0
            vp.acc_reduced = g.reduced_dims
            if inner in g.extent:
                vp.i_lo = g.extent[inner].lo
                vp.i_hi = g.extent[inner].hi
        if kind == "rolling":
            d0 = outer[-1]
            vp.contraction_dim = d0
            vp.stages = window_stages(p_leads[d0],
                                      consumer_positions(np_, v, d0))
        plan.vars[key] = vp
    return plan
