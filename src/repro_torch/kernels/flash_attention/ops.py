"""Attention front door used by the model code (the port of
``repro.kernels.flash_attention.ops``).

Three implementations of one function (same mask semantics):

* ``reference`` -- the dense oracle (:mod:`.ref`), materialises scores;
* ``chunked``   -- an online-softmax loop over KV chunks in plain
  PyTorch: the running (m, l, acc) accumulators are the contracted
  rolling buffers, the softmax the init/combine/finalize reduction
  triple;
* ``pallas``    -- the hand-written CUDA kernel K2 (:mod:`.kernel`);
  the name is the reference's, so configs select the same path in both
  packages.  On CPU tensors the wrapper runs the kernel's plain version.
"""
from __future__ import annotations

import torch

from ...distributed.ctx import split_dim
from .kernel import NEG_INF, flash_attention_fwd
from .ref import dense_attention


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = False, window: int | None = None,
                      kv_len: torch.Tensor | None = None,
                      q_offset: int | None = None,
                      qpos: torch.Tensor | None = None,
                      scale: float | None = None,
                      chunk: int = 512) -> torch.Tensor:
    B, Sq, H, D = q.shape
    Skv, KVH = k.shape[1], k.shape[2]
    group = H // KVH
    scale = scale if scale is not None else D ** -0.5
    C = min(chunk, Skv)
    while C > 1 and Skv % C:
        C //= 2
    qs = split_dim(q.float() * scale, 2, KVH)  # (B, Sq, KVH, group, D)
    if qpos is None:
        q_off = q_offset if q_offset is not None else Skv - Sq
        qpos = torch.arange(Sq, device=q.device)[None, :] + q_off
    qp = qpos[:, :, None]  # (B|1, Sq, 1)
    m = torch.full((B, KVH, group, Sq), NEG_INF, device=q.device)
    l = torch.zeros((B, KVH, group, Sq), device=q.device)
    acc = torch.zeros((B, KVH, group, Sq, D), device=q.device)
    for c0 in range(0, Skv, C):
        kc = k[:, c0:c0 + C].float()
        vc = v[:, c0:c0 + C].float()
        s = torch.einsum("bqhgd,bkhd->bhgqk", qs, kc)
        kpos = c0 + torch.arange(C, device=q.device)
        mask = torch.ones((1, Sq, C), dtype=torch.bool, device=q.device)
        if causal:
            mask = mask & (kpos[None, None, :] <= qp)
        if window is not None:
            mask = mask & (kpos[None, None, :] > qp - window)
        if kv_len is not None:
            mask = mask & (kpos[None, None, :] < kv_len[:, None, None])
        s = torch.where(mask[:, None, None], s, NEG_INF)
        mc = torch.maximum(m, s.amax(-1))
        alpha = torch.exp(m - mc)
        p = torch.exp(s - mc[..., None])
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum("bhgqk,bkhd->bhgqd", p,
                                                    vc)
        m = mc
    out = acc / l.clamp_min(1e-30)[..., None]
    out = out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, D)
    return out.to(q.dtype)


def attention(q, k, v, *, causal: bool = False, window: int | None = None,
              kv_len=None, q_offset: int | None = None, qpos=None,
              scale: float | None = None, impl: str = "chunked",
              chunk: int = 512) -> torch.Tensor:
    """Dispatch across implementations; semantics identical by test."""
    if impl == "reference":
        return dense_attention(q, k, v, causal=causal, window=window,
                               kv_len=kv_len, q_offset=q_offset, qpos=qpos,
                               scale=scale)
    if impl == "chunked":
        return chunked_attention(q, k, v, causal=causal, window=window,
                                 kv_len=kv_len, q_offset=q_offset, qpos=qpos,
                                 scale=scale, chunk=chunk)
    if impl == "pallas":
        if kv_len is not None or qpos is not None:
            raise ValueError("the flash attention kernel is the train/prefill "
                             "path: no kv_len or qpos")
        return flash_attention_fwd(q, k, v, causal=causal, window=window,
                                   q_offset=q_offset, scale=scale)
    raise ValueError(f"unknown attention impl {impl!r}")
