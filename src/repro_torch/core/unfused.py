"""Unfused reference evaluator — the paper's 'autovec' baseline.

The port's counterpart of ``repro.core.unfused``, on torch tensors: the
whole-array oracle the CUDA stencil kernel is held against, and the
'autovec' leg timed beside it on the card.

Executes the dataflow DAG one grouped callsite at a time, materializing
every intermediate as a full array (exactly what the original disparate
loop nests do: one pass over the iteration space per kernel, all
intermediates in memory).  Used as:

* the correctness oracle for the fused backends (same kernel bodies, same
  arithmetic, different schedule), and
* the baseline leg of the paper's performance tables (Figs. 11-13).

Vectorization here is whole-array: every kernel body runs as eager
torch operations over whole arrays, so intermediates round-trip through
device memory between kernels (and between the operations of one body),
the bandwidth-bound behaviour the paper measures.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from .dataflow import DataflowDAG, Group, build_dataflow
from .infer import IDAG, infer
from .rules import Extent, Program
from .terms import Term


@dataclass
class UnfusedProgram:
    program: Program
    idag: IDAG
    dag: DataflowDAG
    fn: Callable
    n_passes: int  # number of separate kernel sweeps (loops over the grid)
    n_intermediates: int  # full arrays materialized between passes


def _offsets_to_slice(ext: Extent, off: int, origin: int, size: int):
    lo = ext.lo + off - origin
    hi = size + ext.hi + off - origin
    return lo, hi


def _as_tensor(x, device) -> torch.Tensor:
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(np.ascontiguousarray(x))
    return torch.as_tensor(x, device=device)


def build_unfused(program: Program, *, device=None) -> UnfusedProgram:
    """The unfused evaluator of ``program``: ``fn(**arrays)`` takes the
    external arrays (tensors or numpy arrays; moved to ``device`` when
    given) and returns ``{store name: tensor}`` for every goal."""
    idag = infer(program)
    dag = build_dataflow(idag)
    order = dag.topo_order()
    kernels = [g for g in order if g.kind == "kernel"]
    inter = [
        v for v in dag.variables.values()
        if not v.is_input and not v.is_output
    ]
    pass_fns = {
        g.gid: g.rule.fn
        for g in kernels
        if g.rule is not None and g.rule.fn is not None and not g.is_reduction
    }

    input_names = sorted({t.base().ref.name for t in idag.axiom_of})
    axiom_ext = {t.base(): ax.extents for t, ax in idag.axiom_of.items()}

    def fn(**arrays):
        arrays = {k: _as_tensor(v, device) for k, v in arrays.items()}
        sizes: dict[str, int] = {}
        for key, exts in axiom_ext.items():
            arr = arrays[key.ref.name]
            for axis, d in enumerate(key.dims):
                e = exts.get(d)
                if e is not None and e.size not in sizes:
                    sizes[e.size] = arr.shape[axis] - (e.hi - e.lo)
        store: dict[Term, torch.Tensor] = {}
        origin: dict[Term, dict[str, int]] = {}
        for key, exts in axiom_ext.items():
            store[key] = arrays[key.ref.name]
            origin[key] = {d: exts[d].lo if d in exts else 0 for d in key.dims}
        dt = arrays[input_names[0]].dtype
        dev = arrays[input_names[0]].device

        def read(g: Group, key: Term, offs: dict[str, int]):
            v = dag.variables[key]
            arr = store[key]
            org = origin[key]
            idx = []
            for d in v.dims:
                ext = g.extent.get(d) or Extent(f"N{d}")
                if d in g.reduced_dims:
                    # a reduction folds its own region (its rule's
                    # ``within``), else all its input holds
                    e = g.extent[d] if d in dict(g.rule.within) \
                        else v.extent.get(d) or ext
                    lo = e.lo - org.get(d, 0)
                    hi = sizes[e.size] + e.hi - org.get(d, 0)
                else:
                    lo, hi = _offsets_to_slice(ext, offs.get(d, 0), org.get(d, 0), sizes[ext.size])
                idx.append(slice(lo, hi))
            return arr[tuple(idx)]

        for g in kernels:
            rule = g.rule
            assert rule is not None and rule.fn is not None
            ins = [read(g, key, offs) for _, key, offs in g.reads]
            if g.is_reduction:
                red_axes = []
                (pname, okey), = g.writes
                v = dag.variables[okey]
                data = ins[0]
                in_key = g.reads[0][1]
                in_dims = dag.variables[in_key].dims
                red_axes = [in_dims.index(d) for d in g.reduced_dims if d in in_dims]
                ident = rule.init
                # simple generic fold: flatten reduced axes and tree-reduce
                moved = torch.movedim(data, red_axes,
                                      list(range(len(red_axes))))
                flat = moved.reshape((-1,) + moved.shape[len(red_axes):])
                n = flat.shape[0]
                while n > 1:
                    half = (n + 1) // 2
                    a = flat[:half]
                    b = flat[half:]
                    if b.shape[0] < a.shape[0]:
                        b = torch.cat([b, torch.full(
                            (a.shape[0] - b.shape[0],) + tuple(b.shape[1:]),
                            ident, dtype=dt, device=dev)])
                    flat = rule.fn(a, b)
                    n = half
                out = flat[0]
                store[okey] = out
                origin[okey] = {}
                continue
            outs = pass_fns[g.gid](*ins)
            if len(g.writes) == 1:
                outs = (outs,)
            for (pname, okey), val in zip(g.writes, outs):
                v = dag.variables[okey]
                store[okey] = val
                origin[okey] = {
                    d: (g.extent[d].lo if d in g.extent else 0) for d in v.dims
                }

        results = {}
        for t, goal in idag.goal_of.items():
            v = dag.variables[t.base()]
            name = goal.store_as or v.name
            val = store[t.base()]
            org = origin[t.base()]
            if v.dims:
                shape = tuple(
                    sizes[(v.extent[d].size if d in v.extent else f"N{d}")]
                    for d in v.dims
                )
                full = torch.zeros(shape, dtype=dt, device=dev)
                idx = []
                for d in v.dims:
                    e = goal.extents.get(d) or Extent(f"N{d}")
                    idx.append(slice(e.lo, sizes[e.size] + e.hi))
                # val covers the goal extent exactly when origins align
                gidx = []
                for d in v.dims:
                    e = goal.extents.get(d) or Extent(f"N{d}")
                    lo = e.lo - org.get(d, 0)
                    gidx.append(slice(lo, lo + (sizes[e.size] + e.hi - e.lo)))
                full[tuple(idx)] = val[tuple(gidx)]
                results[name] = full
            else:
                results[name] = val
        return results

    return UnfusedProgram(
        program, idag, dag, fn, n_passes=len(kernels), n_intermediates=len(inter)
    )
