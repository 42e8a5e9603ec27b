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


#: The layout changes :func:`flat_ready` and :func:`tied` have made in
#: this process (descriptions), for the dry run's record.
LAYOUT_CHANGES: set = set()
_REFUSES: dict[tuple, bool] = {}


def refuses(op: str, mesh) -> bool:
    """Whether the installed DTensor refuses ``op`` over ``mesh``:
    ``"flatten"``, a view that flattens a dim sharded behind the first
    of its group (torch 2.11 raises; 2.13 shards the result strided), or
    ``"add"``, adding a tied weight's two gradients, one sharded over the
    first axis of more than one rank (the embedding's), the other partial
    sums there and sharded over the next (the head's): torch 2.11 turns
    the shard into partial sums, "not supported yet"; 2.13
    reduce-scatters the sums.  Found once per mesh shape, by trying it on
    empty meta DTensors; False on a mesh with no axis of more than one
    rank."""
    axes = [i for i in range(mesh.ndim) if mesh.size(i) > 1][:2]
    key = (op, tuple(mesh.size(i) for i in range(mesh.ndim)))
    if not axes:
        return False
    if key not in _REFUSES:
        n = math.prod(mesh.size(i) for i in axes)

        def meta(pairs):  # (2, n), placed as ``pairs`` (axis, placement)
            place = [Replicate()] * mesh.ndim
            local = [2, n]
            for i, p in pairs:
                place[i] = p
                if p.is_shard():
                    local[p.dim] //= mesh.size(i)
            return DTensor.from_local(torch.empty(local, device="meta"),
                                      mesh, place, run_check=False,
                                      shape=(2, n), stride=(n, 1))
        try:
            if op == "flatten":
                meta([(axes[0], Shard(1))]).view(-1)
            else:
                a = meta([(axes[0], Shard(1))])
                b = meta([(axes[0], Partial())]
                         + [(i, Shard(1)) for i in axes[1:]])
                a + b
                b + a
            _REFUSES[key] = False
        except RuntimeError:
            _REFUSES[key] = True
    return _REFUSES[key]


def tied(w):
    """``w``, a second use of a tied weight (the LM head read from the
    embedding table), whose gradient comes back in ``w``'s own layout
    and so adds to the first use's with no redistribution, where the
    installed DTensor cannot turn the first use's shard into the
    second's partial sums (:func:`refuses`), which adding them may take.
    ``w`` itself without a mesh, when it is not a DTensor, when no
    gradient is taken, or where DTensor can."""
    mesh = active_mesh()
    if mesh is None or not isinstance(w, DTensor) \
            or not (torch.is_grad_enabled() and w.requires_grad) \
            or not refuses("add", mesh):
        return w
    y = _grad_as_forward(w)

    def note(grad):
        if tuple(grad.placements) != tuple(w.placements):
            LAYOUT_CHANGES.add(
                f"the tied LM head's gradient laid out as the embedding "
                f"({tuple(grad.placements)} -> {tuple(w.placements)})")
    y.register_hook(note)
    return y


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


def flat_ready(x, *groups, what: str):
    """``x`` laid out so that an op may flatten each group of its dims
    into one (``groups``: tuples of tensor dims, in the order the op
    flattens them), where the installed DTensor refuses to flatten a dim
    sharded behind the first of its group (:func:`refuses`): such a dim
    is made whole, and ``what`` is recorded in :data:`LAYOUT_CHANGES`.
    ``x`` itself without a mesh, when it is not a DTensor, where DTensor
    can, or when no such dim is sharded."""
    mesh = active_mesh()
    if mesh is None or not isinstance(x, DTensor) \
            or not refuses("flatten", mesh):
        return x
    behind = {d % x.ndim for grp in groups for d in grp[1:]}
    if not any(p.is_shard() and p.dim in behind for p in x.placements):
        return x
    LAYOUT_CHANGES.add(what)
    return x.redistribute(x.device_mesh, [
        Replicate() if p.is_shard() and p.dim in behind else p
        for p in x.placements])


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
