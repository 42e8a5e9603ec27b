"""The non-arithmetic operations a kernel body may call.

Kernel bodies (:mod:`repro_torch.core.programs`) are written once and
run in two worlds: eagerly on torch tensors (the unfused oracle, the
``interp_torch`` interpreter, host steps) and symbolically under the
CUDA emitter's tracer (:mod:`repro_torch.kernels.stencil2d.emit`),
which lowers them to C.  Arithmetic and comparisons dispatch through
the operands' own operators; the three calls below dispatch on argument
type instead: a tracer value (any object whose type defines
``lower_call``) lowers the call to C, anything else goes to torch.
"""
from __future__ import annotations

import math

import torch


def _tracer_type(*args):
    for a in args:
        if hasattr(type(a), "lower_call"):
            return type(a)
    return None


def where(cond, a, b):
    """Elementwise select: ``a`` where ``cond`` holds, else ``b``."""
    t = _tracer_type(cond, a, b)
    if t is not None:
        return t.lower_call("where", cond, a, b)
    return torch.where(cond, a, b)


def sqrt(x):
    """Elementwise IEEE square root."""
    t = _tracer_type(x)
    if t is not None:
        return t.lower_call("sqrt", x)
    if isinstance(x, torch.Tensor):
        return torch.sqrt(x)
    return math.sqrt(x)


def full_like(x, value):
    """An array shaped like ``x`` filled with ``value`` (a scalar
    literal under the tracer)."""
    t = _tracer_type(x)
    if t is not None:
        return t.lower_call("full_like", x, value)
    return torch.full_like(x, value)
