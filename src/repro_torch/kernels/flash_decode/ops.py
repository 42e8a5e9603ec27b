"""Decode-attention front door (the port of
``repro.kernels.flash_decode.ops``): the dense oracle, the chunked
online-softmax loop, or the hand-written CUDA kernel K3 (``"pallas"``,
the reference's name for its kernel)."""
from __future__ import annotations

from ..flash_attention.ops import chunked_attention
from .kernel import flash_decode
from .ref import dense_decode


def decode_attention(q, k_cache, v_cache, lengths, *, window=None,
                     scale=None, impl: str = "chunked", chunk: int = 512):
    """q: (B, H, D) one token per sequence; caches (B, S, KVH, D);
    lengths (B,) count the valid cache positions, the new token's
    included."""
    if impl == "reference":
        return dense_decode(q, k_cache, v_cache, lengths, window=window,
                            scale=scale)
    if impl == "chunked":
        out = chunked_attention(q[:, None], k_cache, v_cache, kv_len=lengths,
                                qpos=(lengths - 1)[:, None], window=window,
                                scale=scale, chunk=chunk)
        return out[:, 0]
    if impl == "pallas":
        return flash_decode(q, k_cache, v_cache, lengths, window=window,
                            scale=scale)
    raise ValueError(f"unknown decode impl {impl!r}")
