"""Iteration-nest fusion (Section 3.3, Figs. 5 & 7).

Two levels:

* :func:`fuse_inest_dag` — topological traversal of the iteration-nest DAG
  maintaining a 'fusing' vertex; an unfusable edge *splits* the DAG, barring
  every vertex reachable from the failed candidate (the cut of Section 3.4).
* :func:`fuse_nodes` — recursive fusion of two nests driven by *rank
  ordering* (global loop order) and *dataflow ordering* (``dataflow_le``
  over induced dataflow subgraphs).  Lower-ranked nests fuse into the
  prologue or epilogue of higher-ranked ones (broadcasts / reductions);
  equal-ranked nests fuse phase-by-phase.

Concave dataflow (a broadcast consuming a reduction's result) fails the
phase-orderability conditions and therefore splits — matching the paper's
normalization example, which fuses to exactly two loop nests.
"""
from __future__ import annotations

from dataclasses import dataclass, field

from .dataflow import DataflowDAG
from .inest import Body, INest, Node, irank, perfect_nest
from .rules import Program


class Unfusable(Exception):
    """Two iteration nests cannot legally share a loop (rank mismatch,
    unorderable phases, or a concave-dataflow reduction split): the
    fusion pass treats this as a *cut* and bars the candidate's
    reachable set into a later top-level nest."""


def _le(dag: DataflowDAG, a: set[int], b: set[int]) -> bool:
    return dag.dataflow_le(a, b)


def _topo_merge_bodies(dag: DataflowDAG, a: Body, b: Body) -> Body:
    """Interleave two bodies respecting dataflow order (always possible)."""
    merged: list[int] = []
    xs, ys = list(a.gids), list(b.gids)
    while xs and ys:
        if _le(dag, {xs[0]}, set(ys)):
            merged.append(xs.pop(0))
        elif _le(dag, {ys[0]}, set(xs)):
            merged.append(ys.pop(0))
        else:  # cycle between leaf kernels cannot happen in a DAG
            raise Unfusable(f"cannot order bodies {xs} vs {ys}")
    merged.extend(xs or ys)
    return Body(merged)


def _order_nodes(dag: DataflowDAG, nodes: list[Node]) -> list[Node]:
    """Topologically order sibling nodes within a phase."""
    pending = list(nodes)
    out: list[Node] = []
    while pending:
        for k, n in enumerate(pending):
            rest: set[int] = set()
            for m in pending:
                if m is not n:
                    rest |= m.groups()
            if _le(dag, n.groups(), rest):
                out.append(n)
                pending.pop(k)
                break
        else:
            raise Unfusable("cyclic sibling nodes in phase")
    return out


def _fuse_phase(dag: DataflowDAG, program: Program, pa: list[Node], pb: list[Node]) -> list[Node]:
    """Fuse the child lists of two like phases.

    Children of equal rank are pairwise fused where dataflow permits;
    everything else is kept separate and topologically ordered.  Siblings
    with a mutual dependency that cannot be fused make the phase unfusable.
    """
    result: list[Node] = list(pa)
    for nb in pb:
        fused = False
        for k, na in enumerate(result):
            if irank(na, program) != irank(nb, program):
                continue
            try:
                result[k] = fuse_nodes(dag, program, na, nb)
                fused = True
                break
            except Unfusable:
                continue
        if not fused:
            result.append(nb)
    return _order_nodes(dag, result)


def _reduction_split(dag: DataflowDAG, a: "INest", b: "INest") -> bool:
    """A consumer of a reduction's accumulator cannot share the reduced
    loop: the combined value only exists after that loop completes, so
    fusing them would read a *partial* accumulator (the concave-dataflow
    split of Section 3.4, Fig. 6)."""
    ga, gb = a.groups(), b.groups()
    for v in dag.variables.values():
        p = v.producer
        if p is None or not p.is_reduction or a.ident not in p.reduced_dims:
            continue
        cons = {u.group.gid for u in v.consumers}
        if (p.gid in ga and cons & gb) or (p.gid in gb and cons & ga):
            return True
    return False


def fuse_nodes(dag: DataflowDAG, program: Program, a: Node, b: Node) -> Node:
    """Recursively fuse two iteration-nest nodes (Fig. 7)."""
    ra, rb = irank(a, program), irank(b, program)
    diff = ra - rb
    if diff == 0:
        if isinstance(a, Body) and isinstance(b, Body):
            return _topo_merge_bodies(dag, a, b)
        assert isinstance(a, INest) and isinstance(b, INest)
        if a.extent.size != b.extent.size:
            raise Unfusable(
                f"extent mismatch on {a.ident}: {a.extent} vs {b.extent}"
            )
        if _reduction_split(dag, a, b):
            raise Unfusable(
                f"{a.ident}-nests split: accumulator consumed inside its "
                f"own reduced loop"
            )
        # Phase orderability (the four conditions of Fig. 7, diff == 0).
        if not (
            _le(dag, a.prlg_only(), b.phase_groups("steady"))
            and _le(dag, b.prlg_only(), a.phase_groups("steady"))
            and _le(dag, a.phase_groups("steady"), b.eplg_only())
            and _le(dag, b.phase_groups("steady"), a.eplg_only())
        ):
            raise Unfusable(f"phases of {a.ident}-nests cannot be ordered")
        return INest(
            a.ident,
            a.extent.union(b.extent),
            prologue=_fuse_phase(dag, program, a.prologue, b.prologue),
            steady=_fuse_phase(dag, program, a.steady, b.steady),
            epilogue=_fuse_phase(dag, program, a.epilogue, b.epilogue),
        )
    # Ranks differ: fuse the lower-ranked node into the higher-ranked
    # nest's prologue or epilogue, by dataflow order (broadcast/reduction
    # placement of Section 3.4).
    low, high = (a, b) if diff < 0 else (b, a)
    assert isinstance(high, INest)
    lg = low.groups()
    before_ok = _le(
        dag, lg, high.phase_groups("steady") | high.phase_groups("epilogue")
    )
    after_ok = _le(
        dag, high.phase_groups("prologue") | high.phase_groups("steady"), lg
    )
    if before_ok:  # ambiguous case resolves to 'before' (paper comment)
        return INest(
            high.ident,
            high.extent,
            prologue=_fuse_phase(dag, program, high.prologue, [low]),
            steady=high.steady,
            epilogue=high.epilogue,
        )
    if after_ok:
        return INest(
            high.ident,
            high.extent,
            prologue=high.prologue,
            steady=high.steady,
            epilogue=_fuse_phase(dag, program, high.epilogue, [low]),
        )
    raise Unfusable(
        f"cannot place rank-{irank(low, program)} nest around {high.ident}-loop"
    )


@dataclass
class FusedSchedule:
    """Linearized fused iteration-nest DAG: top-level nodes in exec order."""

    program: Program
    dag: DataflowDAG
    nests: list[Node] = field(default_factory=list)

    def pretty(self) -> str:
        """Indented loop-nest rendering (used by ``explain``)."""
        by_id = {g.gid: g for g in self.dag.groups}
        return "\n".join(n.pretty(by_id) for n in self.nests)

    def n_toplevel(self) -> int:
        """Number of top-level nests = grid sweeps over the data (the
        paper's pass count, e.g. normalization's 'five to two')."""
        return len(self.nests)


def _reduction_triple_prepass(dag: DataflowDAG, program: Program, nodes: list[Node]) -> list[Node]:
    """Nothing special to do: reduction init/finalize kernels are scalar or
    lower-rank nodes and land in prologues/epilogues through the generic
    rank-differing rule.  Kept as an explicit hook for clarity/tests."""
    return nodes


def fuse_inest_dag(dag: DataflowDAG) -> FusedSchedule:
    """Fuse the iteration-nest DAG (Fig. 5)."""
    program = dag.program
    order = dag.topo_order()
    nodes: dict[int, Node] = {g.gid: perfect_nest(g, program) for g in order}
    node_sets: list[tuple[Node, set[int]]] = [
        (nodes[g.gid], {g.gid}) for g in order
    ]
    node_sets = [(n, s) for n, s in node_sets]

    schedule: list[Node] = []
    pending = node_sets
    while pending:
        cur, cur_gids = pending[0]
        rest = pending[1:]
        barred: set[int] = set()
        leftover: list[tuple[Node, set[int]]] = []
        for cand, cand_gids in rest:
            if cand_gids & barred:
                barred |= dag.reachable(cand_gids)
                leftover.append((cand, cand_gids))
                continue
            try:
                cur = fuse_nodes(dag, program, cur, cand)
                cur_gids = cur_gids | cand_gids
            except Unfusable:
                barred |= dag.reachable(cand_gids)
                leftover.append((cand, cand_gids))
        schedule.append(cur)
        pending = leftover
    return FusedSchedule(program, dag, schedule)
