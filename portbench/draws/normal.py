"""Standard normal values."""
import torch


def draw(g, shape, device):
    return torch.randn(shape, generator=g, device=device)
