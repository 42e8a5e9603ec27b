"""User-facing entry point of the fused stencil kernel."""
from __future__ import annotations

import torch


def run_fused_stencil(program, arrays, *, dtype=torch.float32, device=None,
                      backend: str = "cuda", **options):
    """Compile ``program`` through the HFAV engine onto the CUDA stencil
    kernel and execute it on ``arrays`` (dict name -> tensor or numpy
    array).  Runs on the current CUDA device unless ``device`` says
    otherwise; compilation is cached by the engine."""
    from ...core.engine import compile_program

    gen = compile_program(program, backend=backend, dtype=dtype,
                          device=device, **options)
    return gen.fn(**arrays)
