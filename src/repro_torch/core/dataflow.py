"""Dataflow DAG (the IDAG's RAP dual) + callsite grouping + extents.

Vertices are *grouped* kernel callsites (Section 3.2.2 'Grouping': same
kernel name and parameter list modulo spatial displacements); edges carry
the intermediate variables between them.  Iteration spaces per callsite are
the union over incident variables (Section 3.2), and per-dimension extents
are computed by demand propagation widened by read offsets — the
Minkowski-sum construction of Section 3.5.

All offsets are *canonical-frame relative*: a group computing output
``v[x]`` at iteration point ``x`` reads each input variable ``u`` at
``x + o`` for a fixed offset set ``o``; instance displacements from the
inference stage are folded into consumer read offsets.
"""
from __future__ import annotations

from dataclasses import dataclass, field

from .infer import IDAG, LOAD, RAP, STORE
from .rules import Extent, KernelRule, Program
from .terms import Term


def _disp_of(rap: RAP) -> dict[str, int]:
    """Displacement of a RAP instance = offsets of its anchor term."""
    anchor = rap.out_terms[0] if rap.out_terms else rap.in_terms[0]
    return {ix.dim: ix.off for ix in anchor.ref.indices}


def _group_key(rap: RAP):
    return (
        rap.kind,
        rap.name,
        tuple(t.base() for t in rap.in_terms),
        tuple(t.base() for t in rap.out_terms),
    )


@dataclass
class Group:
    """A grouped kernel callsite (one vertex of the dataflow DAG)."""

    gid: int
    kind: str  # 'kernel' | 'load' | 'store'
    rule: KernelRule | None
    instances: list[RAP]
    # Canonical-frame read offsets per input param: (param_name, var, offsets)
    # where offsets maps dim -> int.  Order matches the rule's param order.
    reads: list[tuple[str, Term, dict[str, int]]] = field(default_factory=list)
    writes: list[tuple[str, Term]] = field(default_factory=list)
    dims: tuple[str, ...] = ()  # iteration dims, outermost-first
    extent: dict[str, Extent] = field(default_factory=dict)

    @property
    def name(self) -> str:
        return self.rule.name if self.rule is not None else self.kind

    @property
    def is_reduction(self) -> bool:
        return self.kind == "kernel" and self.rule is not None and self.rule.is_reduction

    @property
    def reduced_dims(self) -> tuple[str, ...]:
        out_dims = {d for _, v in self.writes for d in v.dims}
        return tuple(d for d in self.dims if d not in out_dims)

    def __str__(self) -> str:  # pragma: no cover
        return f"G{self.gid}:{self.name}{list(self.dims)}"


@dataclass
class VarUse:
    group: Group
    offsets: set[tuple[int, ...]]  # in the var's own dim order


@dataclass
class Var:
    """One variable (edge bundle of the dataflow DAG)."""

    key: Term  # base term, zero displacements
    dims: tuple[str, ...]
    producer: Group | None = None
    consumers: list[VarUse] = field(default_factory=list)
    extent: dict[str, Extent] = field(default_factory=dict)
    is_input: bool = False  # loaded from external storage
    is_output: bool = False  # stored to external storage

    @property
    def name(self) -> str:
        n = self.key.ref.name
        for f in self.key.functors:
            n = f"{f}_{n}"
        return n


@dataclass
class DataflowDAG:
    program: Program
    groups: list[Group]
    variables: dict[Term, Var]
    edges: set[tuple[int, int]]  # (producer gid, consumer gid)
    _succ: dict[int, set[int]] = field(default_factory=dict)
    _pred: dict[int, set[int]] = field(default_factory=dict)

    def succ(self, gid: int) -> set[int]:
        return self._succ.get(gid, set())

    def pred(self, gid: int) -> set[int]:
        return self._pred.get(gid, set())

    def topo_order(self) -> list[Group]:
        indeg = {g.gid: len(self.pred(g.gid)) for g in self.groups}
        ready = sorted([g.gid for g in self.groups if indeg[g.gid] == 0])
        out: list[Group] = []
        by_id = {g.gid: g for g in self.groups}
        while ready:
            gid = ready.pop(0)
            out.append(by_id[gid])
            for s in sorted(self.succ(gid)):
                indeg[s] -= 1
                if indeg[s] == 0:
                    ready.append(s)
        if len(out) != len(self.groups):
            raise ValueError("dataflow DAG has a cycle")
        return out

    def reachable(self, srcs: set[int]) -> set[int]:
        seen = set(srcs)
        stack = list(srcs)
        while stack:
            g = stack.pop()
            for s in self.succ(g):
                if s not in seen:
                    seen.add(s)
                    stack.append(s)
        return seen

    def dataflow_le(self, r_gids: set[int], s_gids: set[int]) -> bool:
        """(R <= S)|D — every node of R can be topologically ordered before
        every node of S, i.e. no (non-trivial) path from S to R
        (Section 3.3.2)."""
        r, s = set(r_gids), set(s_gids)
        if not r or not s:
            return True
        frontier: set[int] = set()
        for g in s:
            frontier |= self.succ(g)
        reach = self.reachable(frontier) if frontier else set()
        return not (reach & (r - s))


def build_dataflow(idag: IDAG) -> DataflowDAG:
    program = idag.program

    # ---- group RAPs -------------------------------------------------------
    groups: list[Group] = []
    by_key: dict = {}
    rap_group: dict = {}
    for rap in idag.raps:
        k = _group_key(rap)
        if k not in by_key:
            g = Group(gid=len(groups), kind=rap.kind, rule=rap.rule, instances=[])
            by_key[k] = g
            groups.append(g)
        by_key[k].instances.append(rap)
        rap_group[rap.key()] = by_key[k]

    # ---- canonical reads/writes per group ---------------------------------
    for g in groups:
        rap = g.instances[0]
        disp = _disp_of(rap)
        pnames_in = (
            [p.name for p in g.rule.inputs] if g.rule else [f"in{k}" for k in range(len(rap.in_terms))]
        )
        pnames_out = (
            [p.name for p in g.rule.outputs] if g.rule else [f"out{k}" for k in range(len(rap.out_terms))]
        )
        for pn, t in zip(pnames_in, rap.in_terms):
            rel = {ix.dim: ix.off - disp.get(ix.dim, 0) for ix in t.ref.indices}
            g.reads.append((pn, t.base(), rel))
        for pn, t in zip(pnames_out, rap.out_terms):
            rel = {ix.dim: ix.off - disp.get(ix.dim, 0) for ix in t.ref.indices}
            if any(v != 0 for v in rel.values()):
                raise ValueError(f"non-canonical output offset in {rap}")
            g.writes.append((pn, t.base()))
        dims = {d for _, t, _ in g.reads for d in t.dims} | {
            d for _, t in g.writes for d in t.dims
        }
        g.dims = program.order_dims(dims)
        # Fold *extra* instance displacements into read offsets: an instance
        # displaced by delta reads u at (base read offset) for output pos
        # x+delta, i.e. the canonical loop covers position x+delta too —
        # handled by extent widening below; read offset sets stay canonical.

    # ---- variables and edges ----------------------------------------------
    variables: dict[Term, Var] = {}

    def var_of(base: Term, dims: tuple[str, ...]) -> Var:
        if base not in variables:
            variables[base] = Var(base, program.order_dims(set(dims)))
        return variables[base]

    edges: set[tuple[int, int]] = set()
    producer_of: dict[Term, Group] = {}
    for g in groups:
        for _, base in g.writes:
            v = var_of(base, base.dims)
            if v.producer is not None and v.producer is not g:
                raise ValueError(f"variable {base} has two producers")
            v.producer = g
            producer_of[base] = g
            if g.kind == LOAD:
                v.is_input = True
    for g in groups:
        seen_terms: dict[Term, VarUse] = {}
        for rap in g.instances:
            disp = _disp_of(rap)
            for t in rap.in_terms:
                base = t.base()
                v = var_of(base, base.dims)
                rel = tuple(
                    ix.off - disp.get(ix.dim, 0)
                    for ix in t.ref.indices
                )
                use = seen_terms.get(base)
                if use is None:
                    use = VarUse(g, set())
                    seen_terms[base] = use
                    v.consumers.append(use)
                use.offsets.add(rel)
        for base in seen_terms:
            p = producer_of.get(base)
            if p is not None and p.gid != g.gid:
                edges.add((p.gid, g.gid))
        if g.kind == STORE:
            for t in g.instances[0].in_terms:
                variables[t.base()].is_output = True

    dag = DataflowDAG(program, groups, variables, edges)
    for a, b in edges:
        dag._succ.setdefault(a, set()).add(b)
        dag._pred.setdefault(b, set()).add(a)

    _compute_extents(idag, dag)
    return dag


def _compute_extents(idag: IDAG, dag: DataflowDAG) -> None:
    """Extent computation (Section 3.5, 'Minkowski sum' footnote).

    1. *Availability* (forward from axioms): the positions at which each
       group can validly compute — the intersection over its reads of the
       input variable's availability shifted by the read offset.
    2. *Demand* (backward from goals): the positions actually required,
       widened by consumer read offsets.  Reduced dimensions (present on
       inputs but not outputs) take their full availability — a reduction
       consumes everything its input can provide — narrowed to the rule's
       region where it names one (``KernelRule.within``).
    """
    order = dag.topo_order()
    axiom_ext: dict[Term, dict[str, Extent]] = {}
    for t, ax in idag.axiom_of.items():
        axiom_ext[t.base()] = ax.extents

    def isect(a: Extent | None, b: Extent) -> Extent:
        if a is None:
            return b
        assert a.size == b.size, f"extent size mismatch {a} vs {b}"
        return Extent(a.size, max(a.lo, b.lo), min(a.hi, b.hi))

    # ---- forward availability ---------------------------------------------
    avail: dict[int, dict[str, Extent]] = {}
    var_avail: dict[Term, dict[str, Extent]] = {}
    for g in order:
        ga: dict[str, Extent] = {}
        if g.kind == LOAD:
            base = g.writes[0][1]
            ga = dict(axiom_ext.get(base, {}))
        else:
            for _, base, offs in g.reads:
                va = var_avail.get(base, {})
                v = dag.variables[base]
                for d, e in va.items():
                    o = offs.get(d, 0)
                    ga[d] = isect(ga.get(d), Extent(e.size, e.lo - o, e.hi - o))
        avail[g.gid] = ga
        for _, base in g.writes:
            # a variable is only constrained in its *own* dims: a dim the
            # producer folded away (a reduction) does not limit where the
            # result may be consumed
            vdims = dag.variables[base].dims
            var_avail[base] = {d: e for d, e in ga.items() if d in vdims}

    # ---- backward demand ----------------------------------------------------
    for g in reversed(order):
        if g.kind == STORE:
            t = g.instances[0].in_terms[0]
            goal = idag.goal_of.get(t)
            if goal is not None:
                g.extent = dict(goal.extents)
            continue
        within = dict(g.rule.within) if g.rule is not None else {}
        if set(within) - set(g.reduced_dims):
            raise ValueError(
                f"{g} narrows {sorted(set(within) - set(g.reduced_dims))}, "
                f"which it does not reduce")
        for d in g.dims:
            if d in g.reduced_dims:
                e = avail[g.gid].get(d)
                if e is None:
                    raise ValueError(
                        f"cannot ground reduced dim {d} of {g} from axioms"
                    )
                g.extent[d] = isect(e, within[d]) if d in within else e
                continue
            acc = None
            for _, base in g.writes:
                v = dag.variables[base]
                if d not in v.dims:
                    continue
                di = v.dims.index(d)
                for use in v.consumers:
                    ce = use.group.extent.get(d)
                    if ce is None:
                        continue
                    for offs in use.offsets:
                        e = Extent(ce.size, ce.lo + offs[di], ce.hi + offs[di])
                        acc = e if acc is None else acc.union(e)
            if acc is not None:
                g.extent[d] = acc
                av = avail[g.gid].get(d)
                if av is not None and (acc.lo < av.lo or acc.hi > av.hi):
                    raise ValueError(
                        f"demanded extent {acc} of {g} in {d} exceeds "
                        f"availability {av} — widen the axiom or narrow the goal"
                    )

    # Variable extents = union of producer extent and consumer demand.
    for v in dag.variables.values():
        for d in v.dims:
            acc = None
            if v.producer is not None and d in v.producer.extent:
                acc = v.producer.extent[d]
            di = v.dims.index(d)
            for use in v.consumers:
                ce = use.group.extent.get(d)
                if ce is None:
                    continue
                for offs in use.offsets:
                    e = Extent(ce.size, ce.lo + offs[di], ce.hi + offs[di])
                    acc = e if acc is None else acc.union(e)
            if acc is not None:
                v.extent[d] = acc
