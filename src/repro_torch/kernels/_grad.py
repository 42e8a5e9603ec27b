"""The forward-only kernels refuse autograd.

K2, K3 and K4 have no backward: their CUDA routes return tensors with no
autograd link, so a loss through them would silently drop the gradient
of every input, and the reference cannot differentiate its Pallas
kernels either.  Their wrappers call :func:`refuse_grad` first, on the
CPU route too, so both devices behave alike.  Training takes the plain
routes (``attn_impl="chunked"``, the configs' default); serving enters
``torch.no_grad`` (:mod:`repro_torch.serve.engine`).
"""
from __future__ import annotations

import torch


def refuse_grad(kernel: str, *tensors: torch.Tensor) -> None:
    """Raise ``RuntimeError`` if grad mode is on and any of ``tensors``
    requires grad."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{kernel} is forward-only (no backward kernel, as in the "
            f"reference): train with attn_impl=\"chunked\", or call it "
            f"under torch.no_grad()")
