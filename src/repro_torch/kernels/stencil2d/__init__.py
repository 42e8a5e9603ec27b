"""The fused rolling-window stencil kernel (CUDA C++ for Hopper).

``kernel.py`` builds, binds and launches the kernel emitted per
CallPlan (``emit.py``) over the hand-written machinery in
``csrc/stencil2d.cuh``; it registers as the plan interpreter
``"cuda"``."""
from .kernel import build_call
from .ops import run_fused_stencil
from .ref import run_unfused_reference

__all__ = ["build_call", "run_fused_stencil", "run_unfused_reference"]
