"""Active-mesh context (the port of ``repro.distributed.ctx``): lets
mesh-agnostic model code lay activations out only when a mesh is in
scope (the dry run, a sharded step); with no mesh every function here
returns its input object itself, so unsharded runs are unchanged.

Under :func:`use_mesh` the model's parameters are DTensors, and
tensors the model makes itself (positions, masks, zeros) count as
replicated (``implicit_replication``), as a value without a sharding
is in the reference's ``jit``.
"""
from __future__ import annotations

import math
from contextlib import contextmanager

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import implicit_replication

from ..tree import tree_leaves, tree_map
from .sharding import axis_sizes, batch_axes, check_device, placements

_ACTIVE: list[tuple[object, str]] = []


@contextmanager
def use_mesh(mesh, policy: str = "fsdp_tp"):
    _ACTIVE.append((mesh, policy))
    try:
        with implicit_replication():
            yield mesh
    finally:
        _ACTIVE.pop()


def active_mesh():
    return _ACTIVE[-1][0] if _ACTIVE else None


def active_policy() -> str:
    return _ACTIVE[-1][1] if _ACTIVE else "fsdp_tp"


def _as_dtensor(x, mesh):
    if isinstance(x, DTensor):
        return x
    check_device(x, mesh)
    return DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def constrain(x, *dims):
    """Constrain activation sharding: 'b' -> data axes, 'm' -> model.
    No-op without an active mesh or when a dim does not divide; under a
    mesh ``x`` comes back a DTensor laid out so, as the reference's
    ``with_sharding_constraint`` lays it out."""
    mesh = active_mesh()
    if mesh is None:
        return x
    policy = active_policy()
    sizes = axis_sizes(mesh)
    baxes = batch_axes(mesh, policy)
    bsize = math.prod(sizes[a] for a in baxes)
    spec = []
    for d, size in zip(dims, x.shape):
        if d == "b" and size % bsize == 0:
            spec.append(baxes)
        elif d == "m" and policy != "fsdp_only" and size % sizes["model"] == 0:
            spec.append("model")
        else:
            spec.append(None)
    spec += [None] * (x.ndim - len(spec))
    return _as_dtensor(x, mesh).redistribute(mesh, placements(spec, mesh))


def whole(x, dim: int):
    """``x`` with tensor dim ``dim`` whole on every rank and no pending
    partial sums (its other dims keep their layout), for an op that
    DTensor shards wrongly or not at all along that dim; ``x`` itself
    without a mesh or when it is not a DTensor."""
    if active_mesh() is None or not isinstance(x, DTensor):
        return x
    d = dim % x.ndim
    target = [Replicate() if p.is_shard(d) or p.is_partial() else p
              for p in x.placements]
    y = x.redistribute(x.device_mesh, target)
    if any(p.is_partial() for p in x.placements):
        y = _grad_as_forward(y)
    return y


def _grad_as_forward(y):
    """``y`` itself, but its gradient comes back in ``y``'s layout: a
    gradient sharded elsewhere is first made so, since DTensor (before
    2.13) cannot turn a shard straight into partial sums, nor split a
    dim sharded anywhere but its leading part."""
    return y.redistribute(y.device_mesh, y.placements)


def split_dim(x, dim: int, n: int):
    """``x`` with dim ``dim`` viewed as (n, size // n): heads out of a
    projection's last dim, GQA groups out of the heads.  Under a mesh
    whose shards of that dim do not hold whole pieces (24 heads over a
    16-wide model axis), DTensor cannot split it, so the dim is made
    whole first; without a mesh this is the plain view."""
    d = dim % x.ndim
    if active_mesh() is not None and isinstance(x, DTensor):
        k = math.prod(x.device_mesh.size(i)
                      for i, p in enumerate(x.placements) if p.is_shard(d))
        if n % k:
            x = whole(x, d)
    return x.unflatten(d, (n, -1))


def merge_last(x):
    """``x`` with its last two dims flattened into one (heads back into
    a projection's width).  Under a mesh the last dim is made whole
    first when it is sharded: DTensor (before 2.13) cannot flatten into
    a dim sharded anywhere but its leading part; without a mesh this is
    the plain reshape."""
    if active_mesh() is None or not isinstance(x, DTensor):
        return x.reshape(*x.shape[:-2], x.shape[-2] * x.shape[-1])
    if any(p.is_shard(x.ndim - 1) for p in x.placements):
        x = whole(x, -1)
    return _grad_as_forward(
        x.reshape(*x.shape[:-2], x.shape[-2] * x.shape[-1]))


def lookup(table, ids):
    """``table[ids]``, rows of an embedding table.  Under a mesh, each
    rank looks up its own rows in the whole table (``local_rows``):
    DTensor's indexing fails in the backward pass (before 2.13) and its
    masked partial sums over a sharded vocabulary fail to reduce (2.13)."""
    if active_mesh() is not None and isinstance(ids, DTensor):
        return local_rows(lambda t, i: (t[i],), table, ids)[0]
    return table[ids]


def put_rows(cache, slot, keep, new) -> None:
    """``cache[b, slot[b]] = new[b]`` for every row ``b`` whose ``keep``
    is false, in place; ``cache`` (B, S, ...), ``new`` (B, ...).  A
    DTensor cache (batch and inner dims sharded, never S) is written
    shard by shard, ``new``, ``slot`` and ``keep`` laid out to match:
    DTensor has no in-place strategy for this scatter."""
    if isinstance(cache, DTensor):
        mesh = cache.device_mesh
        if any(p.is_shard(1) or p.is_partial() for p in cache.placements):
            raise ValueError(f"cannot write rows of a cache laid out as "
                             f"{cache.placements}")
        rows = [Shard(0) if p.is_shard(0) else Replicate()
                for p in cache.placements]
        vals = [Shard(p.dim - 1) if p.is_shard() and p.dim > 1 else r
                for p, r in zip(cache.placements, rows)]
        new = _as_dtensor(new, mesh).redistribute(mesh, vals).to_local()
        slot, keep = (_as_dtensor(t, mesh).redistribute(mesh, rows)
                      .to_local() for t in (slot, keep))
        cache = cache.to_local()
    bidx = torch.arange(cache.shape[0], device=cache.device)
    cache[bidx, slot] = torch.where(keep, cache[bidx, slot],
                                    new.to(cache.dtype))


def local_rows(fn, params, *xs):
    """``fn(params, *xs)`` on each rank's rows: under a mesh, ``xs``
    (batch-leading) with their batch dim over the data axes and the rest
    whole, ``params`` whole, and ``fn``'s outputs (a tuple of
    batch-leading tensors) back as DTensors laid out so.  For work that
    is independent per row and that DTensor has no sharding rules for.
    Without a mesh, ``fn(params, *xs)``."""
    mesh = active_mesh()
    if mesh is None or not any(isinstance(t, DTensor) for t in
                               (*xs, *tree_leaves(params))):
        return fn(params, *xs)
    sizes = axis_sizes(mesh)
    baxes = batch_axes(mesh, active_policy())
    whole_ = [Replicate()] * mesh.ndim
    rows = (placements((baxes,), mesh)
            if xs[0].shape[0] % math.prod(sizes[a] for a in baxes) == 0
            else whole_)
    # each rank's rows give a partial gradient of the whole weights:
    # summed over the batch axes, the same on the others
    grads = [Partial() if a in baxes and p != Replicate() else Replicate()
             for a, p in zip(mesh.mesh_dim_names, rows)]
    local = tree_map(lambda t: _as_dtensor(t, mesh).redistribute(
        mesh, whole_).to_local(grad_placements=grads), params)
    outs = fn(local, *(_as_dtensor(x, mesh).redistribute(mesh, rows)
                       .to_local() for x in xs))
    return tuple(DTensor.from_local(o, mesh, rows, run_check=False)
                 for o in outs)
