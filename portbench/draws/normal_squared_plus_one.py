"""``x * x + 1`` for ``x`` standard normal: positive, at least 1 (a
density)."""
import torch


def draw(g, shape, device):
    x = torch.randn(shape, generator=g, device=device)
    return x.mul_(x).add_(1.0)
