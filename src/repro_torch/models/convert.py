"""Parameters (and AdamW state) between the reference package and the
port.

:func:`params_from_jax` takes the JAX package's parameter pytree as numpy
arrays (``jax.tree.map(np.asarray, params)``) and returns the port's
parameter dictionary on ``device``: the stacked leading layer axis of
``blocks`` (and of encdec's ``enc_blocks``) becomes one dictionary per
layer, every other entry (the hybrid family's ``shared_attn`` block and
encdec's ``enc_norm`` included) is converted as it nests, and every
weight keeps its ``(d_in, d_out)`` layout (the port computes ``x @ w``
as the reference does), so nothing is transposed.
:func:`params_to_jax` is its inverse (the reference's stacked layout as
numpy arrays), and :func:`opt_state_from_jax` carries the reference's
AdamW state (``m``, ``v``, ``step``) across the same way.
"""
from __future__ import annotations

import numpy as np
import torch

from ..configs.base import ArchConfig
from ..core.interpreters import resolve_device
from ..tree import tree_map
from .lm import require_ported


def _tensor(a, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a)).to(device)  # a writable copy


def _split_layers(tree, n: int, device) -> list:
    """One tree per index of the leading axis of every leaf."""
    def take(t, i):
        if t.shape[0] != n:
            raise ValueError(f"stacked leaf of shape {t.shape} has no "
                             f"leading layer axis of {n}")
        return _tensor(t[i], device)
    return [tree_map(lambda t: take(t, i), tree) for i in range(n)]


def params_from_jax(tree: dict, cfg: ArchConfig, device=None) -> dict:
    """The port's parameters from the reference's pytree of numpy
    arrays, on ``device`` (the current CUDA device unless
    ``device="cpu"`` is given)."""
    require_ported(cfg)
    dev = resolve_device(device)
    layers = _layer_axes(cfg)
    out = {k: tree_map(lambda a: _tensor(a, dev), v)
           for k, v in tree.items() if k not in layers}
    for k, n in layers.items():
        out[k] = _split_layers(tree[k], n, dev)
    return out


def _layer_axes(cfg: ArchConfig) -> dict:
    layers = {"blocks": cfg.n_layers}
    if cfg.family == "encdec":
        layers["enc_blocks"] = cfg.encdec.n_enc_layers
    return layers


def _numpy(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def params_to_jax(params: dict, cfg: ArchConfig) -> dict:
    """The reference's parameter pytree, as numpy arrays, from the
    port's parameters (float32 masters, or a tree like them such as
    AdamW's ``m``): ``blocks`` (and ``enc_blocks``) stacked on a
    leading layer axis."""
    require_ported(cfg)
    layers = _layer_axes(cfg)
    out = {k: tree_map(_numpy, v) for k, v in params.items()
           if k not in layers}
    for k in layers:
        out[k] = tree_map(lambda *ts: np.stack([_numpy(t) for t in ts]),
                          *params[k])
    return out


def opt_state_from_jax(state: dict, cfg: ArchConfig, device=None) -> dict:
    """The port's AdamW state from the reference's (``m`` and ``v`` as
    parameter pytrees of numpy arrays, ``step`` a scalar), on
    ``device``."""
    dev = resolve_device(device)
    return {"m": params_from_jax(state["m"], cfg, dev),
            "v": params_from_jax(state["v"], cfg, dev),
            "step": torch.tensor(int(np.asarray(state["step"])),
                                 dtype=torch.int32, device=dev)}
