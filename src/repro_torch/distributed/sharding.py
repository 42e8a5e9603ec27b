"""Sharding rules: FSDP(data[,pod]) x TP(model) over the production mesh
(the port of ``repro.distributed.sharding``).

Every weight is 2-D sharded under ``fsdp_tp``: its largest dim over
``model`` (tensor parallel) and the next over the data axes (FSDP);
``fsdp_only`` and ``zero_dp`` shard one dim over all the weight axes.
Activations are laid out at block boundaries by
:func:`repro_torch.distributed.ctx.constrain`.

A rule's result is a :class:`Spec`, one entry per tensor dim as the
reference's ``PartitionSpec``: ``None`` (whole), an axis name, or a
tuple of axis names (major to minor).  The rules read only the mesh's
axis names and sizes, so they take a ``DeviceMesh`` or an
:class:`~repro_torch.launch.mesh.AbstractMesh` alike.
:func:`placements` turns a spec into DTensor placements on a
``DeviceMesh`` and :func:`distribute` lays a tree out by its specs.

The reference stacks each block's layers on a leading axis it never
shards; the port keeps one dictionary per layer in a list
(:mod:`repro_torch.tree`), so each port leaf gets the reference's
*inner* spec.  The KV and SSM caches are stacked tensors in both
packages and get the same specs.
"""
from __future__ import annotations

import math
from typing import Any

import torch
from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                      distribute_tensor)

from ..tree import tree_map, tree_paths


class Spec(tuple):
    """A partition spec: one entry per tensor dim (``None``, an axis
    name, or a tuple of axis names), compared as a tuple."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"Spec{tuple.__repr__(self)}"


def axis_sizes(mesh) -> dict[str, int]:
    """``{axis name: size}`` of a ``DeviceMesh`` or an abstract mesh."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.shape))
    return dict(mesh.shape)


def batch_axes(mesh, policy: str = "fsdp_tp") -> tuple[str, ...]:
    """The data-parallel axes: ('pod', 'data') multi-pod, else ('data',).
    Under 'fsdp_only' the model axis joins data parallelism."""
    names = axis_sizes(mesh)
    axes = tuple(a for a in ("pod", "data") if a in names)
    if policy == "fsdp_only":
        axes = axes + ("model",)
    return axes


def weight_axes(mesh, policy: str) -> tuple[str, ...]:
    """Axes across which weights are ZeRO-sharded."""
    if policy == "zero_dp":
        # weights sharded over everything; batch only over the data axes
        names = axis_sizes(mesh)
        return tuple(a for a in ("pod", "data", "model") if a in names)
    return batch_axes(mesh, policy)


def _divides(n: int, k: int) -> bool:
    return k > 0 and n % k == 0


def _weight_spec(path: str, shape: tuple[int, ...], mesh,
                 policy: str = "fsdp_tp") -> Spec:
    """fsdp_tp: largest dim over model (TP), second over data (FSDP).
    fsdp_only: largest dim over ALL axes (pure ZeRO-3, no TP)."""
    sizes = axis_sizes(mesh)
    baxes = weight_axes(mesh, policy)
    dp = math.prod(sizes[a] for a in baxes)
    if len(shape) == 0:
        return Spec()
    if len(shape) == 1:
        (n,) = shape
        if _divides(n, dp) and n >= 1024:
            return Spec(baxes)
        return Spec(None)
    order = sorted(range(len(shape)), key=lambda i: -shape[i])
    spec: list[Any] = [None] * len(shape)
    if policy in ("fsdp_only", "zero_dp"):
        # pure ZeRO: shard storage on ONE dim, never contraction-partial
        if _divides(shape[order[0]], dp):
            spec[order[0]] = baxes
        elif len(order) > 1 and _divides(shape[order[1]], dp):
            spec[order[1]] = baxes
        return Spec(*spec)
    tp = sizes["model"]
    if _divides(shape[order[0]], tp):
        spec[order[0]] = "model"
    if len(order) > 1 and _divides(shape[order[1]], dp):
        spec[order[1]] = baxes
    elif spec[order[0]] is None and _divides(shape[order[0]], dp):
        spec[order[0]] = baxes
    return Spec(*spec)


def _path_name(path: tuple) -> str:
    return "/".join(str(k) for k in path)


def _map_with_path(fn, tree):
    """``fn(path name, leaf)`` over ``tree``'s leaves, keeping its
    structure."""
    it = iter(_path_name(p) for p in tree_paths(tree))
    return tree_map(lambda leaf: fn(next(it), leaf), tree)


def param_specs(params, mesh, policy: str = "fsdp_tp"):
    """Spec tree for a model (or optimizer moment) parameter tree; each
    leaf is one layer's tensor, so it gets the reference's per-layer
    spec."""
    return _map_with_path(
        lambda name, leaf: _weight_spec(name, tuple(leaf.shape), mesh,
                                        policy), params)


def sanitize_spec(shape: tuple[int, ...], spec, mesh) -> Spec:
    """Drop mesh axes from dims they do not evenly divide (e.g. batch=1
    decode cells cannot shard over data)."""
    sizes = axis_sizes(mesh)
    out = []
    for i, entry in enumerate(spec):
        if entry is None:
            out.append(None)
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        size = math.prod(sizes[a] for a in axes)
        if i < len(shape) and shape[i] % size == 0:
            out.append(entry)
        else:
            out.append(None)
    return Spec(*out)


def data_specs(mesh, cfg, kind: str) -> dict:
    """Input specs per step kind (tokens/positions/caches...)."""
    b = batch_axes(mesh)
    if kind == "train":
        return {"tokens": Spec(b, None), "targets": Spec(b, None)}
    if kind == "prefill":
        return {"tokens": Spec(b, None)}
    if kind == "decode":
        return {"token": Spec(b), "lengths": Spec(b)}
    raise ValueError(kind)


def cache_specs(mesh, cfg, caches):
    """KV caches: batch over data axes, head_dim over model (divisible for
    all assigned archs: 64/80/128 vs tp=16 -> 4/5/8 lanes)."""
    b = batch_axes(mesh)
    tp = axis_sizes(mesh)["model"]

    def spec(names: str, leaf) -> Spec:
        shp = leaf.shape
        last = "model" if _divides(shp[-1], tp) else None
        if "enc_len" in names:
            return Spec(b)
        if names.endswith("conv") or "/conv" in names:
            # (L, B, W-1, di)
            return Spec(None, b, None, last)
        # ssm state (L, B, H, N, P) and kv caches (L, B, S, KVH, hd)
        return Spec(None, b, None, None, last)

    return _map_with_path(spec, caches)


def placements(spec, mesh) -> list:
    """DTensor placements on ``mesh`` (a ``DeviceMesh``) for ``spec``:
    per mesh dim, ``Shard(d)`` for the tensor dim ``d`` whose entry
    names that axis, else ``Replicate()``.  A dim over several axes is
    split over them major to minor, as the mesh orders them.  An axis of
    size 1 splits nothing, so it stays ``Replicate()`` (older DTensor
    releases refuse views of a dim sharded even over one rank)."""
    out = [Replicate() for _ in mesh.mesh_dim_names]
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        for a in (entry if isinstance(entry, tuple) else (entry,)):
            i = mesh.mesh_dim_names.index(a)
            if mesh.size(i) > 1:
                out[i] = Shard(d)
    return out


def sharded(mesh, leaf, spec) -> list:
    """The placements of ``leaf`` under ``spec`` once sanitized."""
    return placements(sanitize_spec(tuple(leaf.shape), spec, mesh), mesh)


def check_device(t, mesh) -> None:
    """Raise unless ``t`` lies on ``mesh``'s device type (a meta tensor
    lies anywhere): DTensor would copy it there without a word."""
    if not t.is_meta and t.device.type != mesh.device_type:
        raise ValueError(f"a tensor on {t.device} cannot join a mesh on "
                         f"{mesh.device_type!r}; move it first, or build "
                         f"the mesh on its device")


def distribute(tree, specs, mesh):
    """``tree``'s tensors as DTensors on ``mesh``, each laid out by its
    (sanitized) spec; a leaf whose spec is ``None`` stays as it is (it
    counts as replicated under the mesh).  Every rank holds the whole
    tensor, so each keeps its own shard and nothing is sent.  Every
    tensor must lie on the mesh's device type (:func:`check_device`)."""
    def place(leaf, s):
        if isinstance(leaf, torch.Tensor):
            check_device(leaf, mesh)
        if s is None or isinstance(leaf, DTensor):
            return leaf
        return distribute_tensor(leaf, mesh, sharded(mesh, leaf, s),
                                 src_data_rank=None)

    return tree_map(place, tree, specs)
