"""GPipe-style pipeline parallelism with point-to-point sends (the port
of ``repro.distributed.pipeline``).

Layers are partitioned into ``n_stages`` contiguous stages along a mesh
axis, one stage per rank of that axis; microbatches flow through a
software pipeline of ``n_micro + n_stages - 1`` ticks, and at each tick
every stage but the last sends its activation to the next
(``batch_isend_irecv``, the counterpart of ``lax.ppermute``).  A stage
computes only on the ticks that carry one of its microbatches (tick
``t`` carries microbatch ``t - stage``); on the others it passes its
input on unchanged, and the receiver ignores it.  The last stage's
outputs are replicated along the axis by a summing all-reduce of the
outputs masked to it, as the reference's ``psum``.

The implementation is model-agnostic: ``block_fn(layer_params, x) ->
x`` applies one layer, and ``stacked_params`` keeps the reference's
leading layer axis.  Forward only, as the reference's test uses it.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed import _functional_collectives as funcol

from ..roofline.analysis import record
from ..tree import tree_leaves, tree_map


def pipeline_apply(block_fn, stacked_params, x: torch.Tensor, mesh,
                   axis: str, n_micro: int) -> torch.Tensor:
    """Run ``x`` (global batch, ...) through all stages.

    ``stacked_params``: a tree with leading layer axis L, whole on every
    rank; L % n_stages == 0.  Returns ``block_fn`` applied layer by
    layer, equal to the sequential loop, on every rank of ``axis``."""
    n_stages = mesh.size(mesh.mesh_dim_names.index(axis))
    stage = mesh.get_local_rank(axis)
    group = mesh.get_group(axis)
    B = x.shape[0]
    if B % n_micro:
        raise ValueError(f"batch {B} does not split into {n_micro} "
                         f"microbatches")
    L = tree_leaves(stacked_params)[0].shape[0]
    if L % n_stages:
        raise ValueError(f"{L} layers over {n_stages} stages")
    per = L // n_stages
    layers = [tree_map(lambda a, i=i: a[stage * per + i], stacked_params)
              for i in range(per)]
    xs = x.reshape((n_micro, B // n_micro) + x.shape[1:])
    nxt = (dist.get_global_rank(group, stage + 1)
           if stage < n_stages - 1 else None)
    prv = dist.get_global_rank(group, stage - 1) if stage > 0 else None

    state = torch.zeros_like(xs[0])
    outs = torch.zeros_like(xs)
    for t in range(n_micro + n_stages - 1):
        # stage 0 injects microbatch t; the others consume the activation
        # the previous stage sent at the last tick
        h = xs[min(t, n_micro - 1)] if stage == 0 else state
        y = h
        if 0 <= t - stage < n_micro:
            for lp in layers:
                y = block_fn(lp, y)
        ops = []
        if nxt is not None:
            y = y.contiguous()
            ops.append(dist.P2POp(dist.isend, y, nxt, group))
            record("collective-permute", y.numel() * y.element_size(),
                   n_stages)
        if prv is not None:
            state = torch.empty_like(xs[0])
            ops.append(dist.P2POp(dist.irecv, state, prv, group))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        # the last stage emits microbatch t - (n_stages - 1)
        if stage == n_stages - 1 and t >= n_stages - 1:
            outs[t - (n_stages - 1)] = y
    # replicate the last stage's outputs along the pipeline axis
    if stage != n_stages - 1:
        outs.zero_()
    outs = funcol.all_reduce(outs, "sum", group).wait()
    return outs.reshape((B,) + x.shape[1:])
