"""The plain references: one module per configuration, found by the
configuration's name (``reference/<config>.py``).

Each module is a frozen copy of its program's kernel bodies, written as
whole-array PyTorch operations, and imports nothing of the program under
test.  It exports ``forward(arrays) -> {output: tensor}``, which computes
every output array at full size (zero outside the goal's region, as the
program seats its outputs) in the dtype of its inputs, and ``BODIES``,
the kernel bodies by name, from which the yardstick counts the
operations a point costs.
"""
from __future__ import annotations

import importlib

import torch


def load(config_name: str):
    """The reference module of ``config_name``."""
    return importlib.import_module(f"{__name__}.{config_name}")


def where(cond, a, b):
    """``torch.where`` on tensors; on the yardstick's counting scalars,
    the scalar's own ``select`` (a selection costs no operation)."""
    if isinstance(cond, torch.Tensor):
        return torch.where(cond, a, b)
    return cond.select(a, b)
