"""Mamba2 block: in-proj -> causal depthwise conv -> SSD -> gated
out-proj (the port of ``repro.models.ssm``).

The sequence path (train/prefill) runs the SSD chunked scan
(:mod:`repro_torch.kernels.ssd`).  ``cfg.attn_impl`` keeps the
reference's names: ``"pallas"`` selects the hand-written CUDA kernel K4,
``"reference"`` the per-token oracle, anything else the chunked scan.
The reference's ``mamba_forward`` sends every name but ``"reference"``
to its chunked scan, so its model never reaches its SSD kernel; both
compute the same function.

Decode keeps O(1) state per layer: a (conv_width - 1) rolling input
window and the (H, N, P) float32 SSM state, which
:func:`mamba_decode_step` updates IN PLACE (the reference returns a new
cache).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig
from ..kernels.ssd.ops import ssd
from .common import dense_init, rmsnorm, rmsnorm_init, silu


def mamba_init(gen: torch.Generator, cfg: ArchConfig, *, device=None) -> dict:
    s = cfg.ssm
    d = cfg.d_model
    di = s.d_inner(d)
    H = s.n_heads(d)
    N = s.d_state
    f32 = torch.float32
    # in_proj emits [z (di), x (di), B (N), C (N), dt (H)]
    return {
        "w_in": dense_init(gen, d, 2 * di + 2 * N + H, device=device),
        "conv_w": torch.randn((s.conv_width, di), generator=gen,
                              device=device, dtype=f32) * 0.2,
        "conv_b": torch.zeros((di,), dtype=f32, device=device),
        "a_log": torch.log(torch.linspace(1.0, 16.0, H, dtype=f32,
                                          device=device)),
        "dt_bias": torch.zeros((H,), dtype=f32, device=device),
        "d_skip": torch.ones((H,), dtype=f32, device=device),
        "norm": rmsnorm_init(di, device=device),
        "w_out": dense_init(gen, di, d, device=device),
    }


def _split(proj: torch.Tensor, cfg: ArchConfig):
    """``proj`` -> (z, x, B, C, dt), views of its last dim."""
    s = cfg.ssm
    di = s.d_inner(cfg.d_model)
    H = s.n_heads(cfg.d_model)
    N = s.d_state
    return torch.split(proj, [di, di, N, N, H], dim=-1)


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over (B, S, C) with taps (W, C), the taps
    unrolled as in the reference."""
    W, S = w.shape[0], x.shape[1]
    pad = F.pad(x, (0, 0, W - 1, 0))
    out = torch.zeros_like(x)
    for t in range(W):
        out = out + pad[:, t:t + S, :] * w[t]
    return out + b


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``log(1 + exp(x))`` as the reference computes it (``logaddexp``)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


def _ssd_impl(cfg: ArchConfig) -> str:
    if cfg.attn_impl in ("pallas", "reference"):
        return cfg.attn_impl
    return "chunked"


def mamba_forward(p: dict, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """Sequence path (train/prefill): (B, S, d) -> (B, S, d)."""
    s = cfg.ssm
    B, S, _ = x.shape
    di = s.d_inner(cfg.d_model)
    H = s.n_heads(cfg.d_model)
    proj = x @ p["w_in"].to(x.dtype)
    z, xs, bm, cm, dt = _split(proj, cfg)
    xs = silu(_causal_conv(xs, p["conv_w"].to(x.dtype),
                           p["conv_b"].to(x.dtype)))
    dt = _softplus(dt.float() + p["dt_bias"])
    A = -torch.exp(p["a_log"])
    y = ssd(xs.reshape(B, S, H, s.head_dim), dt, A, bm.float(), cm.float(),
            p["d_skip"], chunk=cfg.ssd_chunk,
            impl=_ssd_impl(cfg)).reshape(B, S, di)
    y = rmsnorm(y * silu(z), p["norm"], cfg.norm_eps)
    return y @ p["w_out"].to(x.dtype)


def mamba_cache_init(cfg: ArchConfig, batch: int, dtype: torch.dtype, *,
                     layers: int, device=None) -> dict:
    """Zeroed decode caches of ``layers`` Mamba2 layers: the conv window
    (layers, batch, W - 1, d_inner) in ``dtype`` and the state (layers,
    batch, H, N, P) in float32."""
    s = cfg.ssm
    d = cfg.d_model
    return {
        "conv": torch.zeros((layers, batch, s.conv_width - 1, s.d_inner(d)),
                            dtype=dtype, device=device),
        "state": torch.zeros((layers, batch, s.n_heads(d), s.d_state,
                              s.head_dim), dtype=torch.float32,
                             device=device),
    }


def mamba_decode_step(p: dict, x_t: torch.Tensor, cache: dict,
                      cfg: ArchConfig) -> torch.Tensor:
    """One-token recurrence, (B, d) -> (B, d).  Writes the new conv
    window and state into ``cache`` (this layer's views) in place."""
    s = cfg.ssm
    B = x_t.shape[0]
    di = s.d_inner(cfg.d_model)
    H = s.n_heads(cfg.d_model)
    P = s.head_dim
    proj = x_t @ p["w_in"].to(x_t.dtype)
    z, xs, bm, cm, dt = _split(proj, cfg)
    win = torch.cat([cache["conv"], xs[:, None]], dim=1)  # (B, W, di)
    w = p["conv_w"].to(x_t.dtype)
    xc = silu((win * w[None]).sum(dim=1) + p["conv_b"].to(x_t.dtype))
    cache["conv"].copy_(win[:, 1:])
    dt = _softplus(dt.float() + p["dt_bias"])  # (B, H)
    A = -torch.exp(p["a_log"])
    a = torch.exp(dt * A)
    xh = xc.reshape(B, H, P).float()
    upd = (dt[..., None, None] * bm.float()[:, None, :, None]
           * xh[:, :, None, :])
    state = a[..., None, None] * cache["state"] + upd
    cache["state"].copy_(state)
    y = torch.einsum("bn,bhnp->bhp", cm.float(), state)
    y = y + p["d_skip"][None, :, None] * xh
    y = y.reshape(B, di).to(x_t.dtype)
    y = rmsnorm(y * silu(z), p["norm"], cfg.norm_eps)
    return y @ p["w_out"].to(x_t.dtype)
