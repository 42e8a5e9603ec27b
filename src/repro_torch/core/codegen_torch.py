"""The fused-source backend ``"torch"``: emit fused, vectorized PyTorch
source from a storage plan (Section 3.6).

The port's counterpart of ``repro.core.codegen_jax``.  The emitted
program is a *source string* (faithful to HFAV's source-to-source
design; inspectable via ``Generated.source``) that is ``exec``'d
against :data:`repro_torch.core.runtime.NAMESPACE`.  Shape of the
emitted code:

* one top-level region per fused iteration nest, in topological order;
* loops are plain Python ``for`` loops over *extended* ranges — each
  grouped callsite runs at its own software-pipeline ``lead`` and is
  predicated by an extent mask, an ``if`` on Python integers (the
  reference's ``lax.fori_loop`` and ``jnp.where`` masks).  This folds
  prologue/epilogue iterations into a predicated steady state (the
  paper's 'HFAV + Tuning' variant);
* the innermost dimension is fully vectorized: kernels consume/produce
  whole rows (tensors on the caller's device), with static halo slices
  implementing i-offsets;
* contracted intermediates live in ``(stages, width)`` rolling buffers
  rotated by index arithmetic; reductions use vector partial
  accumulators with an associative lane-reduction epilogue (Fig. 9
  family).  A reduction output that *keeps* dims (row sums ``rsum[j]``,
  subset-outer sums ``out[l]``) gets one accumulator-array axis per kept
  dim: combines update a single cell in place (predicated by the extent
  mask), cells initialize once in the preamble, and the lane reduction
  folds the trailing vector axis on return;
* phase structure (reduction init -> prologue, combine -> steady,
  finalize -> epilogue) is emitted around the loops per the fused nest.

Buffers are tensors updated in place; the loop runs on the host, one
iteration per row, so a call makes a few tensor operations per row.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import torch

from .dataflow import DataflowDAG, Group
from .fusion import FusedSchedule
from .inest import Body, INest, Node
from .infer import IDAG, LOAD, STORE
from .interpreters import as_tensor, resolve_device
from .reuse import NestPlan, StoragePlan, VarPlan
from .runtime import NAMESPACE
from .terms import Term


class CodegenError(Exception):
    pass


class Writer:
    def __init__(self) -> None:
        self.lines: list[str] = []
        self.depth = 0

    def w(self, text: str = "") -> None:
        self.lines.append("    " * self.depth + text if text else "")

    def source(self) -> str:
        return "\n".join(self.lines) + "\n"


@dataclass
class Generated:
    """The paper's end product: generated source + a callable.

    ``fn`` takes the program's external arrays (tensors or numpy arrays,
    by keyword or positionally in sorted name order), moves them to
    ``device`` in ``dtype`` and returns ``{store name: tensor}``."""

    source: str
    fn: Callable
    plan: StoragePlan
    schedule: FusedSchedule
    idag: IDAG
    device: Optional[torch.device] = None
    backend: str = "torch"


def _st(prefix: str, name: str) -> str:
    return f"st['{prefix}_{name}']"


class Emitter:
    def __init__(self, plan: StoragePlan, idag: IDAG):
        self.plan = plan
        self.idag = idag
        self.schedule = plan.schedule
        self.dag: DataflowDAG = plan.schedule.dag
        self.program = plan.schedule.program
        self.inner = self.program.loop_order[-1]
        self.by_id: dict[int, Group] = {g.gid: g for g in self.dag.groups}
        self.w = Writer()
        self.fns: dict[str, Callable] = {}
        self._uid = 0
        # axiom array info: var key -> (array name, extents)
        self.axioms: dict[Term, tuple[str, dict]] = {}
        for t, ax in idag.axiom_of.items():
            self.axioms[t.base()] = (t.base().ref.name, ax.extents)
        self.input_names = sorted({n for n, _ in self.axioms.values()})
        # nest plan per gid
        self.nest_of_gid: dict[int, NestPlan] = {}
        for np_ in plan.nests:
            for gid in np_.gids:
                self.nest_of_gid[gid] = np_

    # ---- small helpers ----------------------------------------------------

    def uid(self) -> int:
        self._uid += 1
        return self._uid

    def vplan(self, key: Term) -> VarPlan:
        return self.plan.vars[key]

    def lead(self, gid: int, d: str) -> int:
        np_ = self.nest_of_gid.get(gid)
        return np_.lead(gid, d) if np_ else 0

    def group_ext(self, g: Group, d: str):
        from .rules import Extent

        return g.extent.get(d, Extent(f"N{d}"))

    def g_ilo(self, g: Group) -> int:
        if self.inner not in g.dims:
            return 0
        return self.group_ext(g, self.inner).lo

    def g_width(self, g: Group) -> str:
        return f"W{g.gid}"

    def _is_reduction_result(self, vp: VarPlan) -> bool:
        """A reduction result stored straight to a goal keeps its
        accumulator storage (kind 'external_out', producer reducing)."""
        return (vp.var.producer is not None
                and vp.var.producer.is_reduction)

    def var_origin(self, vp: VarPlan, d: str) -> int:
        v = vp.var
        if vp.kind == "external_in":
            _, exts = self.axioms[v.key]
            return exts.get(d).lo if d in exts else 0
        if vp.kind == "external_out":
            return 0
        if d in v.extent:
            return v.extent[d].lo
        return 0

    # ---- preamble ----------------------------------------------------------

    def emit_preamble(self) -> None:
        w = self.w
        w.w(f"def hfav_{self.program.name}({', '.join(self.input_names)}):")
        w.depth += 1
        w.w(f"_dt = {self.input_names[0]}.dtype")
        w.w(f"_dev = {self.input_names[0]}.device")
        # sizes from input shapes
        seen: set[str] = set()
        for key, (arr, exts) in sorted(self.axioms.items(),
                                       key=lambda kv: str(kv[0])):
            # axis order follows the term's index order
            for axis, d in enumerate(key.dims):
                ext = exts.get(d)
                if ext is None or ext.size in seen:
                    continue
                seen.add(ext.size)
                corr = ext.hi - ext.lo
                suffix = f" - {corr}" if corr else ""
                w.w(f"{ext.size} = {arr}.shape[{axis}]{suffix}")
        # per-group row widths (kernel groups only: loads are read in place,
        # stores are subsumed by the producers' masked writes)
        for g in self.dag.groups:
            if g.kind == "kernel" and self.inner in g.dims:
                ext = self.group_ext(g, self.inner)
                w.w(f"W{g.gid} = {ext.size} + {ext.hi - ext.lo}")
        w.w("st = {}")
        # storage allocation
        for key, vp in sorted(self.plan.vars.items(),
                              key=lambda kv: str(kv[0])):
            v = vp.var
            if vp.kind == "external_out":
                if self._is_reduction_result(vp):
                    # the goal is the reduction itself: its storage is the
                    # accumulator, finalized in the return expression
                    self._emit_acc_init(vp)
                    continue
                shape = ", ".join(
                    (v.extent[d].size if d in v.extent else f"N{d}")
                    for d in v.dims)
                shape = f"({shape},)" if len(v.dims) == 1 else f"({shape})"
                alias = self._alias_input(v)
                name = _st('o', self._out_name(v))
                if alias:
                    w.w(f"{name} = {alias}.clone()")
                elif v.dims:
                    w.w(f"{name} = torch.zeros({shape}, dtype=_dt, "
                        f"device=_dev)")
                else:
                    w.w(f"{name} = torch.zeros((), dtype=_dt, device=_dev)")
            elif vp.kind == "full":
                parts = []
                for d in v.dims:
                    ext = v.extent.get(d)
                    if ext is None:
                        parts.append(f"N{d}")
                    else:
                        parts.append(f"{ext.size} + {ext.hi - ext.lo}")
                shape = f"({', '.join(parts)},)" if parts else "()"
                w.w(f"{_st('f', v.name)} = torch.zeros({shape}, dtype=_dt, "
                    f"device=_dev)")
            elif vp.kind == "rolling":
                width = self._var_width_expr(vp)
                w.w(f"{_st('b', v.name)} = torch.zeros(({vp.stages}, "
                    f"{width}), dtype=_dt, device=_dev)")
            elif vp.kind == "acc":
                self._emit_acc_init(vp)
            elif vp.kind == "scalar":
                w.w(f"{_st('s', v.name)} = torch.zeros((), dtype=_dt, "
                    f"device=_dev)")

    def _var_width_expr(self, vp: VarPlan) -> str:
        v = vp.var
        if self.inner not in v.dims:
            return "1"
        ext = v.extent.get(self.inner)
        if ext is None:
            return f"N{self.inner}"
        return f"{ext.size} + {ext.hi - ext.lo}"

    def _alias_input(self, v) -> str | None:
        out_name = self._out_name(v)
        for in_name, o_name in self.program.aliases:
            if o_name == out_name:
                return in_name
        return None

    def _out_name(self, v) -> str:
        for t, goal in self.idag.goal_of.items():
            if t.base() == v.key:
                return goal.store_as or v.name
        return v.name

    def _acc_kept(self, v) -> list[str]:
        """Non-vector dims a reduction output keeps: each gets an
        accumulator-array axis (one cell per kept position)."""
        return [d for d in v.dims if d != self.inner]

    def _emit_acc_init(self, vp: VarPlan) -> None:
        v = vp.var
        g = v.producer
        assert g is not None and g.rule is not None
        ident = g.rule.init
        kept = self._acc_kept(v)
        if len(kept) > 3:
            raise CodegenError(
                f"reduction output {v.name} keeps dims {kept}: arrays "
                f"over more than 4 dims are unsupported"
            )
        parts = []
        for d in kept:
            ext = v.extent.get(d)
            parts.append(f"N{d}" if ext is None
                         else f"{ext.size} + {ext.hi - ext.lo}")
        if self.inner in g.dims:  # vector partial accumulator cells
            parts.append(f"W{g.gid}")
        shape = f"({', '.join(parts)},)" if parts else "()"
        self.w.w(f"{_st('a', v.name)} = torch.full({shape}, {ident!r}, "
                 f"dtype=_dt, device=_dev)")

    # ---- expressions --------------------------------------------------------

    def read_expr(self, c: Group, key: Term, offs: dict[str, int],
                  bound: dict[str, str]) -> str:
        vp = self.vplan(key)
        v = vp.var
        c_ilo = self.g_ilo(c)
        oi = offs.get(self.inner, 0)
        wexpr = self.g_width(c) if self.inner in c.dims else None

        def outer_pos(d: str, origin: int) -> str:
            o = offs.get(d, 0)
            base = bound.get(d)
            if base is None:
                raise CodegenError(
                    f"group {c} reads {v.name} over unbound dim {d}"
                )
            lead = self.lead(c.gid, d)
            adj = lead + o - origin
            return f"{base} + {adj}" if adj else base

        if vp.kind == "external_out" and self._is_reduction_result(vp):
            # a goal that IS a reduction result has no 'o' array — its
            # storage is the accumulator; downstream reads go there
            return self._acc_read_expr(c, v, bound, offs)
        if vp.kind in ("external_in", "full", "external_out"):
            if vp.kind == "external_in":
                arr = self.axioms[v.key][0]
            elif vp.kind == "full":
                arr = _st("f", v.name)
            else:
                arr = _st("o", self._out_name(v))
            odims = [d for d in v.dims if d != self.inner]
            if self.inner in v.dims:
                col0 = (c_ilo + oi) - self.var_origin(vp, self.inner)
                if not odims:
                    return f"{arr}[{col0}:{col0} + {wexpr}]"
                pos = [outer_pos(d, self.var_origin(vp, d)) for d in odims]
                if len(odims) > 3:
                    raise CodegenError(
                        f"read of {v.name}: arrays over more than 4 dims "
                        f"are unsupported"
                    )
                fn = f"_row{len(odims) + 1}"
                return f"{fn}({arr}, {', '.join(pos)}, {col0}, {wexpr})"
            if not odims:
                return arr  # 0-dim external
            pos = [outer_pos(d, self.var_origin(vp, d)) for d in odims]
            if len(pos) == 1:
                return f"_at({arr}, {pos[0]})"
            raise CodegenError(f"unsupported read of {v.name}")
        if vp.kind == "rolling":
            d0 = vp.contraction_dim
            assert d0 is not None
            stage_pos = outer_pos(d0, 0)
            col0 = (c_ilo + oi) - vp.i_lo
            return (
                f"_brow({_st('b', v.name)}, ({stage_pos}) % {vp.stages},"
                f" {col0}, {wexpr})"
            )
        if vp.kind == "row":
            prod_ilo = self.g_ilo(v.producer) if v.producer else 0
            col0 = (c_ilo + oi) - prod_ilo
            name = f"r_{v.name}"
            if self.inner in v.dims:
                if col0 == 0 and v.producer is not None \
                        and self.g_width(v.producer) == wexpr:
                    return name
                return f"{name}[{col0}:{col0} + {wexpr}]"
            return name
        if vp.kind == "scalar":
            return _st("s", v.name)
        if vp.kind == "acc":
            return self._acc_read_expr(c, v, bound, offs)
        raise CodegenError(f"cannot read variable {v.name} of kind {vp.kind}")

    def _acc_read_expr(self, c: Group, v, bound: dict[str, str],
                       offs: dict[str, int]) -> str:
        """Read a reduction result from its accumulator storage: one
        cell per kept position, lanes folded when the vector dim was
        reduced."""
        g = v.producer
        assert g is not None and g.rule is not None
        kept = self._acc_kept(v)
        if kept:
            pos = self._acc_pos(c, v, bound, offs)
            if self.inner in g.dims:
                cell = (f"_row{len(kept) + 1}({_st('a', v.name)}, "
                        f"{', '.join(pos)}, 0, W{g.gid})")
            else:
                cell = f"_at({_st('a', v.name)}, {', '.join(pos)})"
        else:
            cell = _st("a", v.name)
        if self.inner in g.reduced_dims:
            return (
                f"_lane_reduce(_fns['{g.rule.name}'], {cell},"
                f" {g.rule.init!r})"
            )
        return cell

    def valid_expr(self, g: Group, bound: dict[str, str]) -> str:
        terms = []
        for d in g.dims:
            if d == self.inner or d not in bound:
                continue
            ext = self.group_ext(g, d)
            lead = self.lead(g.gid, d)
            p = f"({bound[d]} + {lead})" if lead else bound[d]
            terms.append(f"{ext.lo} <= {p} < {ext.size} + {ext.hi}")
        return " and ".join(terms) if terms else "True"

    # ---- group emission ------------------------------------------------------

    def emit_group(self, g: Group, bound: dict[str, str]) -> None:
        if g.kind == LOAD:
            return  # consumers read external arrays directly
        if g.kind == STORE:
            # The producing kernel's masked write already materializes the
            # terminal output (its variable has kind 'external_out').
            return
        assert g.rule is not None
        if g.rule.fn is None:
            raise CodegenError(f"kernel {g.rule.name} has no fn")
        self.fns[g.rule.name] = g.rule.fn
        if g.is_reduction:
            self._emit_reduce(g, bound)
        else:
            self._emit_map(g, bound)

    def _in_exprs(self, g: Group, bound: dict[str, str]) -> list[str]:
        return [self.read_expr(g, key, offs, bound)
                for _, key, offs in g.reads]

    def _emit_map(self, g: Group, bound: dict[str, str]) -> None:
        w = self.w
        ins = self._in_exprs(g, bound)
        outs = [f"t{g.gid}_{k}" for k in range(len(g.writes))]
        w.w(f"{', '.join(outs)} = _fns['{g.rule.name}']({', '.join(ins)})")
        for (pname, key), tmp in zip(g.writes, outs):
            self._emit_write(g, key, tmp, bound)

    def _acc_pos(self, g: Group, v, bound: dict[str, str],
                 offs: dict[str, int] | None = None) -> list[str]:
        """Index expressions locating a kept-dim accumulator cell."""
        pos = []
        for d in self._acc_kept(v):
            base = bound.get(d)
            if base is None:
                raise CodegenError(
                    f"accumulator {v.name} indexed over unbound dim {d}")
            origin = v.extent[d].lo if d in v.extent else 0
            adj = self.lead(g.gid, d) + (offs.get(d, 0) if offs else 0) \
                - origin
            pos.append(f"{base} + {adj}" if adj else base)
        return pos

    def _predicated(self, valid: str, lines: list[str]) -> None:
        """Emit ``lines``, under ``if valid:`` unless it always holds."""
        w = self.w
        if valid != "True":
            w.w(f"if {valid}:")
            w.depth += 1
        for line in lines:
            w.w(line)
        if valid != "True":
            w.depth -= 1

    def _emit_reduce(self, g: Group, bound: dict[str, str]) -> None:
        ins = self._in_exprs(g, bound)
        (_, key), = g.writes
        v = self.vplan(key).var
        acc = _st("a", v.name)
        valid = self.valid_expr(g, bound)
        kept = self._acc_kept(v)
        fn = f"_fns['{g.rule.name}']"
        if not kept:
            self._predicated(valid, [f"{acc} = {fn}({acc}, {', '.join(ins)})"])
            return
        # kept-dim reduction: combine one accumulator cell in place
        pos = ", ".join(self._acc_pos(v.producer, v, bound))
        cur = f"_ac{g.gid}"
        if self.inner in g.dims:  # vector cells, row write-back
            n = len(kept) + 1
            self._predicated(valid, [
                f"{cur} = _row{n}({acc}, {pos}, 0, W{g.gid})",
                f"_setrow{n}({acc}, {pos}, 0, {fn}({cur}, {', '.join(ins)}),"
                f" True)"])
        else:
            self._predicated(valid, [
                f"{cur} = _at({acc}, {pos})",
                f"{acc}[{pos}] = {fn}({cur}, {', '.join(ins)})"])

    def _emit_write(self, g: Group, key: Term, tmp: str,
                    bound: dict[str, str]) -> None:
        w = self.w
        vp = self.vplan(key)
        v = vp.var
        if vp.kind == "rolling":
            d0 = vp.contraction_dim
            lead = self.lead(g.gid, d0)
            p = f"({bound[d0]} + {lead})" if lead else bound[d0]
            # producer row must be aligned to the buffer origin
            if self.g_ilo(g) != vp.i_lo:
                raise CodegenError(
                    f"producer/buffer row misalignment for {v.name}")
            w.w(f"_bset({_st('b', v.name)}, ({p}) % {vp.stages}, {tmp})")
        elif vp.kind == "row":
            w.w(f"r_{v.name} = {tmp}")
        elif vp.kind == "scalar":
            w.w(f"{_st('s', v.name)} = {tmp}")
        elif vp.kind in ("full", "external_out"):
            arr = _st("f", v.name) if vp.kind == "full" \
                else _st("o", self._out_name(v))
            odims = [d for d in v.dims if d != self.inner]
            valid = self.valid_expr(g, bound)
            if self.inner in v.dims:
                col0 = self.g_ilo(g) - self.var_origin(vp, self.inner)
                if not odims:
                    w.w(f"{arr}[{col0}:{col0} + {self.g_width(g)}] = {tmp}")
                else:
                    pos = []
                    for d in odims:
                        adj = self.lead(g.gid, d) - self.var_origin(vp, d)
                        base = bound[d]
                        pos.append(f"{base} + {adj}" if adj else base)
                    if len(odims) > 3:
                        raise CodegenError(
                            f"write of {v.name}: arrays over more than "
                            f"4 dims are unsupported"
                        )
                    fn = f"_setrow{len(odims) + 1}"
                    w.w(f"{fn}({arr}, {', '.join(pos)}, {col0}, {tmp}, "
                        f"{valid})")
            elif not odims:
                w.w(f"{arr} = {tmp}")
            else:
                raise CodegenError(f"unsupported write of {v.name}")
        else:
            raise CodegenError(f"cannot write {v.name} of kind {vp.kind}")

    # ---- nests ---------------------------------------------------------------

    def _loop_bounds(self, nest: INest) -> tuple[str, str]:
        d = nest.ident
        los, his = [], []
        size = None
        for gid in nest.phase_groups("steady"):
            g = self.by_id[gid]
            if d not in g.dims or g.kind != "kernel":
                continue  # loads/stores emit no code and set no bounds
            ext = self.group_ext(g, d)
            lead = self.lead(gid, d)
            los.append(ext.lo - lead)
            his.append(ext.hi - lead)
            size = ext.size
        if size is None:
            size = nest.extent.size
            los, his = [nest.extent.lo], [nest.extent.hi]
        lo = min(los)
        hi = max(his)
        return str(lo), f"{size} + {hi}" if hi else str(size)

    def emit_node(self, node: Node, bound: dict[str, str]) -> None:
        w = self.w
        if isinstance(node, Body):
            for gid in node.gids:
                self.emit_group(self.by_id[gid], bound)
            return
        # acc resets: a reduction's identity initialization belongs to the
        # prologue of its outermost reduced loop (the paper's triple).
        for key, vp in self.plan.vars.items():
            if vp.kind != "acc" and not (
                    vp.kind == "external_out"
                    and self._is_reduction_result(vp)):
                continue
            g = vp.var.producer
            if g is None or g.gid not in node.groups():
                continue
            if self._acc_kept(vp.var):
                # kept-dim accumulators hold one cell per kept position:
                # initialized once in the preamble, never reset (a reset
                # here would wipe cells of earlier kept iterations)
                continue
            red = list(g.reduced_dims)
            outermost = red[0] if red else None
            if outermost == node.ident:
                self._emit_acc_init(vp)
        if node.ident == self.inner:
            # The innermost dimension is vectorized: kernels consume whole
            # rows, so its phases emit inline with no loop.
            for phase in (node.prologue, node.steady, node.epilogue):
                for child in phase:
                    self.emit_node(child, bound)
            return
        for child in node.prologue:
            self.emit_node(child, bound)
        lo, hi = self._loop_bounds(node)
        x = f"x_{node.ident}{self.uid()}"
        w.w(f"for {x} in range({lo}, {hi}):")
        w.depth += 1
        n_lines = len(w.lines)
        inner_bound = dict(bound)
        inner_bound[node.ident] = x
        for child in node.steady:
            self.emit_node(child, inner_bound)
        if len(w.lines) == n_lines:
            w.w("pass")
        w.depth -= 1
        for child in node.epilogue:
            self.emit_node(child, bound)

    # ---- the whole program ------------------------------------------------------

    def _seat_goal(self, goal, v, kept: list[str], expr: str,
                   tail_w: str | None = None) -> str:
        """Re-seat a kept-dim accumulator (spanning ``v.extent``) at its
        goal origin inside full-size output dims; identity when every
        kept extent is already exact.  ``tail_w`` names the width of a
        trailing vector axis (a reduction output keeping the innermost
        dim), carried through unseated."""
        from .rules import Extent

        exact = True
        for d in kept:
            ve = v.extent.get(d, Extent(f"N{d}"))
            ge = goal.extents.get(d, Extent(ve.size))
            if ve.lo != 0 or ve.hi != 0 or ge.lo != 0 or ge.hi != 0:
                exact = False
        if exact:
            return expr
        shape, src, dst = [], [], []
        for d in kept:
            ve = v.extent.get(d, Extent(f"N{d}"))
            ge = goal.extents.get(d, Extent(ve.size))
            shape.append(ge.size)
            span = f"{ge.size} + {ge.hi - ge.lo}"
            src.append(f"{ge.lo - ve.lo}:{ge.lo - ve.lo} + {span}")
            dst.append(f"{ge.lo}:{ge.size} + {ge.hi}")
        if tail_w is not None:
            shape.append(tail_w)
            src.append(":")
            dst.append(":")
        return (f"_seat(({', '.join(shape)},), _S[{', '.join(dst)}], "
                f"{expr}[{', '.join(src)}])")

    def emit(self) -> str:
        self.emit_preamble()
        for node in self.schedule.nests:
            self.emit_node(node, {})
        outs = []
        for t, goal in self.idag.goal_of.items():
            v = self.dag.variables[t.base()]
            name = goal.store_as or v.name
            vp = self.vplan(t.base())
            if vp.kind == "external_out" and self._is_reduction_result(vp):
                g = v.producer
                assert g is not None and g.rule is not None
                kept = self._acc_kept(v)
                acc = _st("a", v.name)
                tail_w = None
                if self.inner in g.reduced_dims:
                    folded = acc if not kept else \
                        f"torch.movedim({acc}, -1, 0)"
                    expr = (f"_lane_reduce(_fns['{g.rule.name}'], "
                            f"{folded}, {g.rule.init!r})")
                else:
                    expr = acc
                    if self.inner in g.dims:
                        tail_w = f"W{g.gid}"
                expr = self._seat_goal(goal, v, kept, expr, tail_w)
                outs.append(f"'{name}': {expr}")
            else:
                outs.append(f"'{name}': {_st('o', name)}")
        self.w.w(f"return {{{', '.join(sorted(set(outs)))}}}")
        self.w.depth -= 1
        return self.w.source()


def generate(plan: StoragePlan, idag: IDAG, *, dtype=torch.float32,
             device=None) -> Generated:
    """Emit ``plan``'s fused source, ``exec`` it, and wrap the function
    so it runs on ``device`` (see
    :func:`repro_torch.core.interpreters.resolve_device`) in ``dtype``."""
    dev = resolve_device(device)
    em = Emitter(plan, idag)
    source = em.emit()
    ns = dict(NAMESPACE)
    ns["_fns"] = em.fns
    exec(compile(source, f"<hfav:{plan.schedule.program.name}>", "exec"), ns)
    raw = ns[f"hfav_{plan.schedule.program.name}"]

    def fn(*args, **arrays):
        return raw(*(as_tensor(a, dtype, dev) for a in args),
                   **{k: as_tensor(a, dtype, dev) for k, a in arrays.items()})

    return Generated(source, fn, plan, plan.schedule, idag, device=dev)
