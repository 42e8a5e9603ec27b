"""Sedov's start: the density, 1 everywhere (HydroC's ``hydro_init``, as
recalled)."""
import torch


def draw(g, shape, device):
    return torch.ones(shape, device=device)
