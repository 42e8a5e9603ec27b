"""The Mamba2 SSD chunked scan (K4): the hand-written CUDA kernel, its
plain version ``ssd_scan``, the per-token oracle and the ``ssd`` front
door."""
from .kernel import ssd_kernel
from .ops import ssd, ssd_scan
from .ref import naive_ssd

__all__ = ["naive_ssd", "ssd", "ssd_kernel", "ssd_scan"]
