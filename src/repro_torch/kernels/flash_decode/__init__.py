"""Split-KV decode attention (K3): the hand-written CUDA kernel, its
plain version, the dense oracle and the ``decode_attention`` front
door."""
from .kernel import flash_decode
from .ops import decode_attention
from .ref import dense_decode

__all__ = ["decode_attention", "dense_decode", "flash_decode"]
