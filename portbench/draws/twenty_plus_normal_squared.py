"""``20 + x * x`` for ``x`` standard normal: a total energy large enough
beside the kinetic energy of ``normal`` momenta over a density of at
least 1 that the internal energy is positive at all but about ``e**-20``
of the points."""
import torch


def draw(g, shape, device):
    x = torch.randn(shape, generator=g, device=device)
    return x.mul_(x).add_(20.0)
