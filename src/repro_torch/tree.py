"""The port's parameter tree: nested dictionaries, and lists (or
tuples) of per-layer dictionaries under ``blocks`` and ``enc_blocks``;
anything else is a leaf.  This module owns the traversal order: the
optimizer, the checkpoints and the converters all walk a tree here, so
their leaves line up."""
from __future__ import annotations

from typing import Callable


def _children(tree):
    """``(key, child)`` pairs of an inner node, or ``None`` at a leaf."""
    if isinstance(tree, dict):
        return tree.items()
    if isinstance(tree, (list, tuple)):
        return enumerate(tree)
    return None


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and the same positions of
    ``rest``), keeping the structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The leaves in the order :func:`tree_map` visits them."""
    out: list = []
    tree_map(out.append, tree)
    return out


def tree_paths(tree, prefix: tuple = ()) -> list[tuple]:
    """Each leaf's path (dictionary keys and list indices), in
    :func:`tree_leaves` order."""
    children = _children(tree)
    if children is None:
        return [prefix]
    return [p for k, v in children for p in tree_paths(v, prefix + (k,))]
