"""Flash attention forward (K2): the hand-written CUDA kernel, its plain
version, the dense oracle and the ``attention`` front door."""
from .kernel import flash_attention_fwd
from .ops import attention, chunked_attention
from .ref import dense_attention

__all__ = ["attention", "chunked_attention", "dense_attention",
           "flash_attention_fwd"]
