"""Checkpoints with atomic commits (the port of
``repro.ckpt.checkpoint``).

Layout: ``<dir>/step_<N>/`` holds one ``.npy`` per leaf of the tree,
named by its path (``params__blocks__3__attn__wq``: dictionary keys and
list indices joined by ``__``), and ``manifest.json``.  A save is
written into ``.tmp_step_<N>``, its manifest last, and becomes visible
only when that directory is renamed to ``step_<N>``; ``latest_step``
counts only directories with a manifest, so a crash mid-save is never
resumed from.

Leaves are written whole, from any device.  numpy has no bf16, so a
bf16 leaf is stored as its ``uint16`` bits with ``"bfloat16"`` as the
manifest's dtype.  ``restore(dir, step, like)`` returns ``like``'s
structure with each leaf on the device and in the dtype of ``like``'s
leaf there.
"""
from __future__ import annotations

import json
import os
import shutil

import numpy as np
import torch

from ..tree import tree_leaves, tree_map, tree_paths

_BITS = {torch.bfloat16: (np.uint16, torch.uint16)}


def _names(tree) -> list[str]:
    """The leaf names in :func:`tree_leaves` order."""
    return ["__".join(map(str, path)) for path in tree_paths(tree)]


def _to_numpy(t: torch.Tensor) -> tuple[np.ndarray, str]:
    t = t.detach().cpu()
    if t.dtype in _BITS:
        return t.view(_BITS[t.dtype][1]).numpy(), str(t.dtype).split(".")[1]
    arr = t.numpy()
    return arr, str(arr.dtype)


def save(ckpt_dir: str, step: int, tree) -> str:
    """Commit ``tree`` as ``step_<step>`` and return its directory."""
    tmp = os.path.join(ckpt_dir, f".tmp_step_{step}")
    final = os.path.join(ckpt_dir, f"step_{step}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    manifest = {"step": step, "leaves": []}
    for name, leaf in zip(_names(tree), tree_leaves(tree)):
        arr, dtype = _to_numpy(leaf)
        np.save(os.path.join(tmp, name + ".npy"), arr)
        manifest["leaves"].append(
            {"name": name, "shape": list(arr.shape), "dtype": dtype})
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)  # atomic commit
    return final


def latest_step(ckpt_dir: str) -> int | None:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(d.split("_", 1)[1]) for d in os.listdir(ckpt_dir)
             if d.startswith("step_")
             and os.path.exists(os.path.join(ckpt_dir, d, "manifest.json"))]
    return max(steps) if steps else None


def restore(ckpt_dir: str, step: int, like):
    """The tree saved as ``step_<step>``, in ``like``'s structure, each
    leaf on the device and in the dtype of ``like``'s."""
    final = os.path.join(ckpt_dir, f"step_{step}")
    with open(os.path.join(final, "manifest.json")) as f:
        manifest = json.load(f)
    by_name = {m["name"]: m for m in manifest["leaves"]}
    names = iter(_names(like))

    def load(ref: torch.Tensor) -> torch.Tensor:
        name = next(names)
        if name not in by_name:
            raise KeyError(f"checkpoint {final} has no leaf {name}")
        t = torch.from_numpy(np.load(os.path.join(final, name + ".npy")))
        if by_name[name]["dtype"] == "bfloat16":
            t = t.view(torch.bfloat16)
        if tuple(t.shape) != tuple(ref.shape):
            raise ValueError(f"leaf {name}: saved {tuple(t.shape)}, "
                             f"expected {tuple(ref.shape)}")
        return t.to(device=ref.device, dtype=ref.dtype)

    return tree_map(load, like)


def prune(ckpt_dir: str, keep: int = 3) -> None:
    """Delete all but the newest ``keep`` committed checkpoints."""
    if not os.path.isdir(ckpt_dir):
        return
    steps = sorted(int(d.split("_", 1)[1]) for d in os.listdir(ckpt_dir)
                   if d.startswith("step_"))
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s}"), ignore_errors=True)
