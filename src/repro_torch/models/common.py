"""Functional module primitives: plain tensor functions over parameter
dictionaries, the port of ``repro.models.common``.

The norms upcast to float32 inside and cast back to the input's dtype,
as the reference does, so a bf16 model normalises in float32.  Weights
are made by a caller's ``torch.Generator`` on its ``device``.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}


def dense_init(gen: torch.Generator, d_in: int, d_out: int,
               scale: float | None = None, *, device=None) -> torch.Tensor:
    """A ``(d_in, d_out)`` float32 weight, N(0, 1) * ``scale`` (default
    ``1/sqrt(d_in)``); used as ``x @ w``."""
    s = scale if scale is not None else 1.0 / math.sqrt(d_in)
    return torch.randn((d_in, d_out), generator=gen, device=device,
                       dtype=torch.float32) * s


def embed_init(gen: torch.Generator, vocab: int, d: int, *,
               device=None) -> torch.Tensor:
    return torch.randn((vocab, d), generator=gen, device=device,
                       dtype=torch.float32) * 0.02


def rmsnorm_init(d: int, *, device=None) -> torch.Tensor:
    return torch.ones((d,), dtype=torch.float32, device=device)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-5) -> torch.Tensor:
    x32 = x.float()
    var = (x32 * x32).mean(-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * scale).to(x.dtype)


def layernorm_init(d: int, *, device=None) -> dict:
    return {"scale": torch.ones((d,), dtype=torch.float32, device=device),
            "bias": torch.zeros((d,), dtype=torch.float32, device=device)}


def layernorm(x: torch.Tensor, p: dict, eps: float = 1e-5) -> torch.Tensor:
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = ((x32 - mu) ** 2).mean(-1, keepdim=True)
    return ((x32 - mu) * torch.rsqrt(var + eps) * p["scale"]
            + p["bias"]).to(x.dtype)


def silu(x: torch.Tensor) -> torch.Tensor:
    return F.silu(x)


def _sinusoids(pos: torch.Tensor, d: int) -> torch.Tensor:
    """(n,) float32 positions -> (n, d): sin at even columns, cos at odd."""
    dim = torch.arange(0, d, 2, device=pos.device).float()[None, :]
    angle = pos[:, None] / torch.pow(10000.0, dim / d)
    # interleaved without writing into a buffer, so that a DTensor of
    # positions (under a mesh) works too
    return torch.stack([torch.sin(angle), torch.cos(angle)],
                       dim=-1).reshape(pos.shape[0], d)


def sinusoidal_positions(seq: int, d: int, offset: int = 0, *,
                         device=None) -> torch.Tensor:
    """Sinusoidal embeddings of positions ``offset .. offset + seq - 1``,
    (seq, d) float32."""
    pos = torch.arange(offset, offset + seq, device=device).float()
    return _sinusoids(pos, d)


def sinusoidal_at(positions: torch.Tensor, d: int) -> torch.Tensor:
    """Sinusoidal embeddings at the positions (B,) of a tensor -> (B, d)
    float32."""
    return _sinusoids(positions.float(), d)
