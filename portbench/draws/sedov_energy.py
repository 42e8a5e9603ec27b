"""Sedov's start: the total energy, ``1e-5`` everywhere but the point
explosion, ``1 / dx**2`` in the first interior cell of the corner,
``(2, 2)`` (HydroC's ``hydro_init``, as recalled).  The last axis holds
the grid's ``n - 4`` interior cells inside a two-cell frame, over a unit
length: ``dx = 1 / (n - 4)``."""
import torch

BACKGROUND = 1e-5


def draw(g, shape, device):
    e = torch.full(shape, BACKGROUND, device=device)
    dx = 1.0 / (shape[-1] - 4)
    e[..., 2, 2] = 1.0 / dx / dx
    return e
