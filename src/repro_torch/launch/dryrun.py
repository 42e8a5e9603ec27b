"""Multi-pod dry run (the port of ``repro.launch.dryrun``).

For every (architecture x input-shape) cell and mesh, on one host:

1. **Full build**: the cell at full depth over the production mesh,
   (16, 16) or (2, 16, 16), every parameter, optimizer moment, cache and
   batch laid out as a DTensor by the sharding rules.  The mesh's 256
   or 512 ranks are a fake process group (backend ``"fake"``: its
   collectives return at once and move nothing) and every tensor is on
   the meta device, so nothing is allocated and nothing is sent.
2. **Counted runs**: the step of the 1- and 2-unit configs
   (``specs.with_units``) runs on those meta DTensors under
   :class:`CostCounter`, and the counts are extrapolated linearly to the
   full depth (``roofline.analysis.extrapolate``); train cells add a run
   at 2 microbatches for the per-microbatch weight re-gathers, as the
   reference does.

What is counted, per device (rank 0 stands for every rank):

* ``flops``: the FLOPs of the local ops, by the formulas of
  ``torch.utils.flop_counter`` (``FlopCounterMode``'s registry: matrix
  products, convolutions and attention; element-wise work is not
  counted);
* ``bytes``: bytes accessed, the sum over every local op that is not a
  view of the bytes of its tensor inputs and outputs (each op reads its
  inputs once and writes its outputs once: no cache, no fusion);
* collectives: one record per functional collective that DTensor's
  redistributions issue (``roofline.analysis.CollectiveLog``).

A DTensor op passes through the counter (it returns ``NotImplemented``
for DTensors), so the counter sees the local ops DTensor runs on each
shard; DTensor's own shape propagation (on fake tensors) is not counted.

There is no compiled ``memory_analysis()``: the record's
``memory_stats`` is an estimate under the reference's three keys, and
says so (``memory_estimate``): ``argument_size_in_bytes`` is the local
bytes of the full cell's placed arguments; ``output_size_in_bytes`` and
``temp_size_in_bytes`` are the local bytes of the step's outputs and the
peak of the bytes of live tensors the step made, extrapolated from the
counted runs.  Results land as JSON in ``reports/dryrun_torch/``.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-0.6b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --both-meshes [--out DIR]
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback
import weakref

import torch
from torch.distributed.tensor import DTensor
from torch.utils.flop_counter import flop_registry

from ..configs import SHAPES, get_arch
from ..roofline.analysis import (CollectiveLog, Roofline, collective_bytes,
                                 extrapolate, model_flops_for)
from ..tree import tree_leaves
from .mesh import make_production_mesh
from .specs import build_cell, iter_cells, target_units, with_units

#: What a family's counts hold beyond an even split over the mesh: work
#: that runs whole on every rank of the model axis (``distributed.ctx``),
#: written into each record of that family as ``note``.
REPEATED_OVER_MODEL = {
    "moe": "routing, dispatch and combine (the router's product, sorts, "
           "gathers, scatter-adds) run on each rank's rows with the router "
           "whole, so every rank of the model axis repeats them; the expert "
           "products split over it",
    "ssm": "each Mamba2 layer's conv, SSD scan, gate and decode state "
           "update run with d_inner whole (DTensor cannot cut the fused "
           "in-projection's output into its pieces), so every rank of the "
           "model axis repeats them; only the in- and out-projections "
           "split over it",
}
REPEATED_OVER_MODEL["hybrid"] = REPEATED_OVER_MODEL["ssm"]


def _tensors(xs) -> list:
    out = []
    for x in xs:
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (list, tuple)):
            out.extend(_tensors(x))
    return out


def _nbytes(t: torch.Tensor) -> int:
    if isinstance(t, DTensor):
        t = t.to_local()
    return t.numel() * t.element_size()


#: Ops that allocate and touch no memory.
_ALLOCS = frozenset({torch.ops.aten.empty, torch.ops.aten.empty_strided,
                     torch.ops.aten.empty_like, torch.ops.aten.new_empty,
                     torch.ops.aten.new_empty_strided})


def _is_view(func) -> bool:
    return any(r.alias_info is not None and not r.alias_info.is_write
               for r in func._schema.returns)


class CostCounter(CollectiveLog):
    """FLOPs, bytes accessed and live bytes of the local ops run while
    it is active, and (as a :class:`CollectiveLog`) their
    collectives."""

    def __init__(self) -> None:
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.live = 0
        self.peak = 0

    def _free(self, n: int) -> None:
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        if any(issubclass(t, torch._subclasses.FakeTensor) for t in types):
            # DTensor's shape propagation: not a device's work
            return func(*args, **kwargs)
        packet = func._overloadpacket
        if packet not in flop_registry and func is not torch.ops.prim.device.default:
            with self:
                r = func.decompose(*args, **kwargs)
            if r is not NotImplemented:
                return r
        out = super().__torch_dispatch__(func, types, args, kwargs)
        if packet in flop_registry:
            self.flops += flop_registry[packet](*args, **kwargs, out_val=out)
        if _is_view(func) or packet in _ALLOCS:
            return out
        ins = _tensors(list(args) + list(kwargs.values()))
        outs = _tensors([out])
        self.bytes += sum(_nbytes(t) for t in ins + outs)
        seen = {id(t) for t in ins}
        for t in outs:
            if id(t) in seen or t._base is not None:
                continue
            n = _nbytes(t)
            self.live += n
            self.peak = max(self.peak, self.live)
            weakref.finalize(t, self._free, n)
        return out


def _local_bytes(tree) -> int:
    return sum(_nbytes(t) for t in _tensors(tree_leaves(tree)))


def _costs(cell) -> tuple[dict, dict]:
    """A counted run of ``cell``: ``(cost, memory)``, ``cost`` with
    ``flops``, ``bytes`` and ``coll:<kind>``; ``memory`` with the step's
    outputs and peak live bytes.  The step runs twice and the second run
    is counted: the first fills DTensor's sharding-propagation cache,
    whose shape propagation makes tensors of the global shapes."""
    cell.run(*cell.place())
    placed = cell.place()
    with CostCounter() as counter:
        out = cell.run(*placed)
    cost = {"flops": float(counter.flops), "bytes": float(counter.bytes)}
    for k, v in collective_bytes(counter.records).items():
        cost[f"coll:{k}"] = v
    outs = list(out) if isinstance(out, tuple) else [out]
    if cell.kind == "decode":
        outs.append(placed[2])  # the caches, written in place
    mem = {"output_size_in_bytes": float(_local_bytes(outs)),
           "temp_size_in_bytes": float(counter.peak)}
    return cost, mem


def run_cell(arch: str, shape_name: str, *, multi_pod: bool, out_dir: str,
             skip_full: bool = False, cfg_mutate: dict | None = None,
             policy: str | None = None, grad_comp: str = "none",
             microbatch_override: int | None = None, tag: str = "") -> dict:
    mesh_name = "2x16x16" if multi_pod else "16x16"
    t0 = time.time()
    mesh = make_production_mesh(multi_pod=multi_pod)
    n_chips = mesh.size()
    cfg = get_arch(arch)
    if cfg_mutate:
        cfg = cfg.replace(**cfg_mutate)
    policy = policy or cfg.parallelism
    shape = SHAPES[shape_name]
    rec: dict = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                 "n_chips": n_chips, "status": "ok", "tag": tag,
                 "policy": policy, "cfg_mutate": cfg_mutate or {}}
    if cfg.family in REPEATED_OVER_MODEL:
        rec["note"] = ("per-device counts (FLOPs, bytes, memory) include "
                       "work repeated over the model axis: "
                       + REPEATED_OVER_MODEL[cfg.family])
    try:
        # ---- 1. full build (every leaf laid out on the mesh) ----------
        mem_stats: dict = {}
        if not skip_full:
            cell = build_cell(arch, shape_name, mesh, cfg_override=cfg,
                              microbatch_override=microbatch_override,
                              policy=policy, grad_comp=grad_comp)
            mem_stats["argument_size_in_bytes"] = _local_bytes(
                list(cell.place()))
            rec["microbatches"] = cell.microbatches
            del cell
        t_full = time.time() - t0

        # ---- 2. counted runs, extrapolated -----------------------------
        units = target_units(cfg)
        mb = rec.get("microbatches", 1)

        def counted(u: int, m: int):
            return _costs(build_cell(
                arch, shape_name, mesh, cfg_override=with_units(cfg, u, shape),
                microbatch_override=m, policy=policy, grad_comp=grad_comp))

        (c1, m1), (c2, m2) = counted(1, 1), counted(2, 1)
        ex = extrapolate(c1, c2, units)
        if shape.kind == "train" and mb > 1:
            c3, _ = counted(1, 2)
            for k in ex:
                ex[k] += (mb - 1) * units * max(0.0, c3[k] - c1[k])
        rec["cost_points"] = {"u1": c1, "u2": c2, "units": units}
        if not skip_full:
            mem_stats.update({k: int(v) for k, v in
                              extrapolate(m1, m2, units).items()})
            rec["memory_estimate"] = (
                "per-device estimate: the placed arguments' local shards; "
                "outputs and peak live bytes extrapolated from the counted "
                "runs (no compiled memory analysis)")
            print(f"[{arch} x {shape_name} x {mesh_name}] "
                  f"memory (estimate): {mem_stats}")

        coll_total = sum(v for k, v in ex.items() if k.startswith("coll:"))
        roof = Roofline(
            arch=arch, shape=shape_name, mesh=mesh_name, n_chips=n_chips,
            flops_per_device=ex["flops"],
            bytes_per_device=ex["bytes"],
            coll_bytes_per_device=coll_total,
            coll_breakdown={k[5:]: v for k, v in ex.items()
                            if k.startswith("coll:")},
            model_flops=model_flops_for(cfg, shape),
            memory_stats=mem_stats,
        )
        rec.update(roof.to_dict())
        rec["t_wall_full_compile_s"] = round(t_full, 1)
        rec["t_wall_total_s"] = round(time.time() - t0, 1)
        print(f"  t_compute={roof.t_compute:.4f}s t_memory={roof.t_memory:.4f}s "
              f"t_collective={roof.t_collective:.4f}s -> {roof.bottleneck} "
              f"(roofline fraction {roof.roofline_fraction:.3f}) "
              f"[total {rec['t_wall_total_s']}s]")
    except Exception as e:  # noqa: BLE001 — record the failure, keep sweeping
        rec["status"] = "error"
        rec["error"] = f"{type(e).__name__}: {e}"
        traceback.print_exc()
    os.makedirs(out_dir, exist_ok=True)
    suffix = f"__{tag}" if tag else ""
    path = os.path.join(out_dir, f"{arch}__{shape_name}__{mesh_name}{suffix}.json")
    with open(path, "w") as f:
        json.dump(rec, f, indent=1, default=str)
    return rec


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--skip-full", action="store_true",
                    help="counted runs only (skip the full build)")
    ap.add_argument("--out", default="reports/dryrun_torch")
    ap.add_argument("--tag", default="", help="variant suffix for the record")
    ap.add_argument("--policy", default=None, choices=[None, "fsdp_tp", "fsdp_only", "zero_dp"])
    ap.add_argument("--cast-once", action="store_true")
    ap.add_argument("--microbatches", type=int, default=None)
    ap.add_argument("--ssd-chunk", type=int, default=None)
    ap.add_argument("--attn-chunk", type=int, default=None)
    ap.add_argument("--grad-comp", default="none", choices=["none", "bf16"])
    args = ap.parse_args(argv)
    mutate: dict = {}
    if args.cast_once:
        mutate["cast_once"] = True
    if args.ssd_chunk:
        mutate["ssd_chunk"] = args.ssd_chunk
    if args.attn_chunk:
        mutate["attn_chunk"] = args.attn_chunk

    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    cells: list[tuple[str, str]] = []
    if args.all:
        for arch, shape_name, skip in iter_cells():
            if skip:
                for mp in meshes:
                    mesh_name = "2x16x16" if mp else "16x16"
                    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                           "status": "skipped", "reason": skip}
                    os.makedirs(args.out, exist_ok=True)
                    with open(os.path.join(
                            args.out, f"{arch}__{shape_name}__{mesh_name}.json"),
                            "w") as f:
                        json.dump(rec, f, indent=1)
                    print(f"[{arch} x {shape_name}] SKIP: {skip}")
                continue
            cells.append((arch, shape_name))
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape (or --all)")
        cells = [(args.arch, args.shape)]

    ok = err = 0
    for arch, shape_name in cells:
        for mp in meshes:
            rec = run_cell(arch, shape_name, multi_pod=mp, out_dir=args.out,
                           skip_full=args.skip_full, cfg_mutate=mutate,
                           policy=args.policy, grad_comp=args.grad_comp,
                           microbatch_override=args.microbatches,
                           tag=args.tag)
            if rec["status"] == "ok":
                ok += 1
            else:
                err += 1
    print(f"dry-run complete: {ok} ok, {err} errors")
    if err:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
