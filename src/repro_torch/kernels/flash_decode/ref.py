"""Oracle: dense decode attention over the cache with length masking
(the port of ``repro.kernels.flash_decode.ref``)."""
from __future__ import annotations

from ..flash_attention.ref import dense_attention


def dense_decode(q, k_cache, v_cache, lengths, *, window=None, scale=None):
    """q (B, H, D), one token per sequence at position lengths - 1;
    caches (B, S, KVH, D)."""
    out = dense_attention(q[:, None], k_cache, v_cache, kv_len=lengths,
                          qpos=(lengths - 1)[:, None], window=window,
                          scale=scale)
    return out[:, 0]
