"""The plain oracle: the unfused pass-per-kernel reference evaluator."""
from __future__ import annotations

from ...core.unfused import build_unfused


def run_unfused_reference(program, arrays, *, device=None):
    return build_unfused(program, device=device).fn(**arrays)
