"""Plain reference of ``cosmo``: COSMO's fourth-order horizontal
diffusion (HFAV paper, section 5.3) as whole-array operations.

For every level ``k``: the 5-point Laplacian of ``u`` on the interior,
the limited fluxes along ``i`` and ``j`` from ``u`` and its Laplacian,
and the stage update ``unew = u - 0.1 * (flux divergence)`` on the
region ``j, i in [2, n - 2)``; ``unew`` is zero elsewhere.
"""
from __future__ import annotations

import torch

from . import where


def ulap(n, e, s, w, c):
    return n + e + s + w - 4.0 * c


def flux(u0, u1, l0, l1):
    fl = l1 - l0
    return where(fl * (u1 - u0) > 0.0, 0.0, fl)


def ustage(c, fxm, fx, fym, fy):
    return c - 0.1 * ((fx - fxm) + (fy - fym))


#: Each body once per output point (the fused nest evaluates each once).
BODIES = {"ulapstage": ulap, "flux_x": flux, "flux_y": flux,
          "ustage": ustage}


def forward(arrays: dict) -> dict:
    u = arrays["u"]
    lap = torch.zeros_like(u)
    lap[:, 1:-1, 1:-1] = ulap(u[:, :-2, 1:-1], u[:, 1:-1, 2:],
                              u[:, 2:, 1:-1], u[:, 1:-1, :-2],
                              u[:, 1:-1, 1:-1])
    fx = torch.zeros_like(u)
    fx[:, :, 1:-2] = flux(u[:, :, 1:-2], u[:, :, 2:-1],
                          lap[:, :, 1:-2], lap[:, :, 2:-1])
    fy = torch.zeros_like(u)
    fy[:, 1:-2, :] = flux(u[:, 1:-2, :], u[:, 2:-1, :],
                          lap[:, 1:-2, :], lap[:, 2:-1, :])
    del lap
    unew = torch.zeros_like(u)
    unew[:, 2:-2, 2:-2] = ustage(u[:, 2:-2, 2:-2], fx[:, 2:-2, 1:-3],
                                 fx[:, 2:-2, 2:-2], fy[:, 1:-3, 2:-2],
                                 fy[:, 2:-2, 2:-2])
    return {"unew": unew}
