"""Dense feed-forward blocks: SwiGLU (LLaMA family) and GELU (whisper);
the port of ``repro.models.mlp``.  Weights keep the reference's
``(d_in, d_out)`` layout and are applied as ``x @ w``."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .common import dense_init, silu


def swiglu_init(gen: torch.Generator, d: int, ff: int, *, device=None):
    return {
        "w_gate": dense_init(gen, d, ff, device=device),
        "w_up": dense_init(gen, d, ff, device=device),
        "w_down": dense_init(gen, ff, d, scale=1.0 / math.sqrt(ff),
                             device=device),
    }


def swiglu(p: dict, x: torch.Tensor) -> torch.Tensor:
    g = silu(x @ p["w_gate"].to(x.dtype))
    u = x @ p["w_up"].to(x.dtype)
    return (g * u) @ p["w_down"].to(x.dtype)


def gelu_mlp_init(gen: torch.Generator, d: int, ff: int, *, device=None):
    return {
        "w_in": dense_init(gen, d, ff, device=device),
        "w_out": dense_init(gen, ff, d, scale=1.0 / math.sqrt(ff),
                            device=device),
    }


def gelu_mlp(p: dict, x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation
    h = F.gelu(x @ p["w_in"].to(x.dtype), approximate="tanh")
    return h @ p["w_out"].to(x.dtype)
