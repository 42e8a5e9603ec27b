"""GQA attention layer with KV cache, sliding window, qk-norm, M-RoPE
and cross attention (the port of ``repro.models.attention``).  Cache
layout: (B, S_max, KVH, D) per layer.

``cfg.attn_impl`` keeps the reference's names.  ``"pallas"`` selects the
hand-written CUDA kernels: flash attention (K2) at train/prefill and for
cross attention (non-causal, at decode with one query row), split-KV
flash decode (K3) for self attention at decode.  The reference's
``decode_self_attention`` sends ``"pallas"`` to its chunked scan instead;
both compute the same function.
"""
from __future__ import annotations

import math

import torch

from ..configs.base import ArchConfig
from ..kernels.flash_attention.ops import attention
from ..kernels.flash_decode.ops import decode_attention
from .common import dense_init, rmsnorm, rmsnorm_init
from .rope import apply_rope


def attn_init(gen: torch.Generator, cfg: ArchConfig, *, device=None) -> dict:
    d, hd, H, KVH = cfg.d_model, cfg.hd, cfg.n_heads, cfg.n_kv_heads
    p = {
        "wq": dense_init(gen, d, H * hd, device=device),
        "wk": dense_init(gen, d, KVH * hd, device=device),
        "wv": dense_init(gen, d, KVH * hd, device=device),
        "wo": dense_init(gen, H * hd, d, scale=1.0 / math.sqrt(H * hd),
                         device=device),
    }
    if cfg.qk_norm:
        p["q_norm"] = rmsnorm_init(hd, device=device)
        p["k_norm"] = rmsnorm_init(hd, device=device)
    return p


def _project_q(p: dict, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    B, S, _ = x.shape
    q = (x @ p["wq"].to(x.dtype)).reshape(B, S, cfg.n_heads, cfg.hd)
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"], cfg.norm_eps)
    return q


def _project_kv(p: dict, x: torch.Tensor, cfg: ArchConfig):
    B, S, _ = x.shape
    k = (x @ p["wk"].to(x.dtype)).reshape(B, S, cfg.n_kv_heads, cfg.hd)
    v = (x @ p["wv"].to(x.dtype)).reshape(B, S, cfg.n_kv_heads, cfg.hd)
    if cfg.qk_norm:
        k = rmsnorm(k, p["k_norm"], cfg.norm_eps)
    return k, v


def self_attention(p: dict, x: torch.Tensor, cfg: ArchConfig, *,
                   positions: torch.Tensor, causal: bool = True):
    """Train/prefill path; returns ``(out, (k, v))`` so callers can fill
    caches."""
    q = _project_q(p, x, cfg)
    k, v = _project_kv(p, x, cfg)
    q = apply_rope(q, positions, theta=cfg.rope_theta,
                   mrope_sections=cfg.mrope_sections)
    k = apply_rope(k, positions, theta=cfg.rope_theta,
                   mrope_sections=cfg.mrope_sections)
    o = attention(q, k, v, causal=causal, window=cfg.window, q_offset=0,
                  impl=cfg.attn_impl, chunk=cfg.attn_chunk)
    B, S = x.shape[:2]
    out = o.reshape(B, S, cfg.n_heads * cfg.hd) @ p["wo"].to(x.dtype)
    return out, (k, v)


def decode_self_attention(p: dict, x_t: torch.Tensor, cfg: ArchConfig, *,
                          cache_k: torch.Tensor, cache_v: torch.Tensor,
                          lengths: torch.Tensor) -> torch.Tensor:
    """One-token step.  ``lengths`` counts tokens INCLUDING the new one.

    The new (k, v) is written at index ``lengths - 1`` of ``cache_k`` and
    ``cache_v`` IN PLACE (the reference returns updated copies; a row
    past the cache is dropped there and keeps its value here), then the
    token attends over the caches.  The caches are this layer's views of
    the model's cache tensors, so a cache from before a step is not kept.
    """
    B = x_t.shape[0]
    x = x_t[:, None]  # (B, 1, d)
    q = _project_q(p, x, cfg)
    k, v = _project_kv(p, x, cfg)
    pos = (lengths - 1)[:, None]  # (B, 1)
    rp = pos if cfg.mrope_sections is None else pos.expand(3, B, 1)
    q = apply_rope(q, rp, theta=cfg.rope_theta,
                   mrope_sections=cfg.mrope_sections)
    k = apply_rope(k, rp, theta=cfg.rope_theta,
                   mrope_sections=cfg.mrope_sections)
    # a row past the cache keeps its old value, as the reference's
    # scatter drops it; clamped and selected on the device, with no host
    # read of ``lengths``
    bidx = torch.arange(B, device=x.device)
    last = (lengths - 1).long()
    max_seq = cache_k.shape[1]
    keep = ((last < 0) | (last >= max_seq))[:, None, None]
    slot = last.clamp(0, max_seq - 1)
    for cache, new in ((cache_k, k), (cache_v, v)):
        cache[bidx, slot] = torch.where(keep, cache[bidx, slot],
                                        new[:, 0].to(cache.dtype))
    if cfg.attn_impl == "pallas":
        # K3 reads the caches in their own dtype and rounds to x's
        o = decode_attention(q[:, 0], cache_k, cache_v, lengths,
                             window=cfg.window, impl="pallas")
    else:
        o = decode_attention(q[:, 0], cache_k.to(x.dtype),
                             cache_v.to(x.dtype), lengths, window=cfg.window,
                             impl=cfg.attn_impl, chunk=cfg.attn_chunk)
    return o.reshape(B, cfg.n_heads * cfg.hd) @ p["wo"].to(x.dtype)


def cross_attention(p: dict, x: torch.Tensor, enc_kv, cfg: ArchConfig
                    ) -> torch.Tensor:
    """Decoder-to-encoder attention, not causal: x (B, S, d) attends over
    ``enc_kv = (k, v)``, each (B, Se, KVH, D), computed once by
    :func:`encode_cross_kv`.  With ``"pallas"`` this is K2 at prefill
    and at decode (S = 1), as in the reference."""
    B, S, _ = x.shape
    q = _project_q(p, x, cfg)
    k, v = enc_kv
    o = attention(q, k, v, causal=False, impl=cfg.attn_impl,
                  chunk=cfg.attn_chunk)
    return o.reshape(B, S, cfg.n_heads * cfg.hd) @ p["wo"].to(x.dtype)


def encode_cross_kv(p: dict, enc_out: torch.Tensor, cfg: ArchConfig):
    """The cross attention's (k, v) of the encoder's output."""
    return _project_kv(p, enc_out, cfg)
