"""Plain oracle: dense softmax attention with GQA, causal and
sliding-window masks (the port of ``repro.kernels.flash_attention.ref``).
Materialises the full (Sq, Skv) score matrix -- the unfused form whose
contraction yields flash attention.  Computes in the inputs' dtype as
the reference does (scores widened to float32, probabilities cast back
to v's dtype for the product with v)."""
from __future__ import annotations

import torch


def dense_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = False, window: int | None = None,
                    kv_len: torch.Tensor | None = None,
                    q_offset: int | None = None,
                    qpos: torch.Tensor | None = None,
                    scale: float | None = None) -> torch.Tensor:
    """q (B, Sq, H, D); k, v (B, Skv, KVH, D); kv_len (B,) valid kv
    length; q_offset: position of q[0] on the kv axis (default
    Skv - Sq); qpos (B, Sq): explicit query positions."""
    B, Sq, H, D = q.shape
    Skv, KVH = k.shape[1], k.shape[2]
    if H % KVH:
        raise ValueError(f"{H} query heads do not group over {KVH} KV heads")
    group = H // KVH
    scale = scale if scale is not None else D ** -0.5
    kr = k.repeat_interleave(group, dim=2)
    vr = v.repeat_interleave(group, dim=2)
    logits = torch.einsum("bqhd,bkhd->bhqk", q * scale, kr).float()
    if qpos is None:
        q_off = q_offset if q_offset is not None else Skv - Sq
        qpos = torch.arange(Sq, device=q.device)[None, :] + q_off
    qp = qpos[:, None, :, None]  # (B|1, 1, Sq, 1)
    kpos = torch.arange(Skv, device=q.device)[None, None, None, :]
    m = torch.ones((1, 1, Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        m = m & (kpos <= qp)
    if window is not None:
        m = m & (kpos > qp - window)
    if kv_len is not None:
        m = m & (kpos < kv_len[:, None, None, None])
    logits = logits.masked_fill(~m, float("-inf"))
    p = torch.nan_to_num(torch.exp(logits - logits.amax(-1, keepdim=True)))
    p = p / p.sum(-1, keepdim=True).clamp_min(1e-30)
    return torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype), vr)
