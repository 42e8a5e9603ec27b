"""Sedov's start: a momentum, 0 everywhere (the gas at rest)."""
import torch


def draw(g, shape, device):
    return torch.zeros(shape, device=device)
