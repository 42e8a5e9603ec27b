"""Parameters of the reference package into the port.

:func:`params_from_jax` takes the JAX package's parameter pytree as numpy
arrays (``jax.tree.map(np.asarray, params)``) and returns the port's
parameter dictionary on ``device``: the stacked leading layer axis of
``blocks`` (and of encdec's ``enc_blocks``) becomes one dictionary per
layer, every other entry (the hybrid family's ``shared_attn`` block and
encdec's ``enc_norm`` included) is converted as it nests, and every
weight keeps its ``(d_in, d_out)`` layout (the port computes ``x @ w``
as the reference does), so nothing is transposed.
"""
from __future__ import annotations

import numpy as np
import torch

from ..configs.base import ArchConfig
from ..core.interpreters import resolve_device
from .lm import require_ported


def _tensor(a, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a)).to(device)  # a writable copy


def _convert(tree, device):
    if isinstance(tree, dict):
        return {k: _convert(v, device) for k, v in tree.items()}
    return _tensor(tree, device)


def _split_layers(tree, n: int, device) -> list:
    """One tree per index of the leading axis of every leaf."""
    def take(t, i):
        if isinstance(t, dict):
            return {k: take(v, i) for k, v in t.items()}
        if t.shape[0] != n:
            raise ValueError(f"stacked leaf of shape {t.shape} has no "
                             f"leading layer axis of {n}")
        return _tensor(t[i], device)
    return [take(tree, i) for i in range(n)]


def params_from_jax(tree: dict, cfg: ArchConfig, device=None) -> dict:
    """The port's parameters from the reference's pytree of numpy
    arrays, on ``device`` (the current CUDA device unless
    ``device="cpu"`` is given)."""
    require_ported(cfg)
    dev = resolve_device(device)
    layers = {"blocks": cfg.n_layers}
    if cfg.family == "encdec":
        layers["enc_blocks"] = cfg.encdec.n_enc_layers
    out = {k: _convert(v, dev) for k, v in tree.items() if k not in layers}
    for k, n in layers.items():
        out[k] = _split_layers(tree[k], n, dev)
    return out
