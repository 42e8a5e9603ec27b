"""Plain reference of ``hydro1d``: the Hydro2D dimensionally split sweep
along ``i`` (HFAV paper, section 5.4) as whole-array operations.

Primitive velocity and pressure at every point, a limited slope and the
traced left and right states at ``i in [1, n - 1)``, the interface state
of a two-state Riemann choice and its flux at ``i in [1, n - 2)``, and the
conservative update ``rnew = rho - 0.05 * (f[i] - f[i - 1])`` on
``i in [2, n - 2)``; ``rnew`` is zero elsewhere.

The Riemann choice ``pL > pR`` is a step: where the two pressures tie to
within float32's rounding, the program may take either branch, and both
are its answer.  :func:`undecided` marks the outputs that read such a
choice, so that the comparison leaves them out.
"""
from __future__ import annotations

import torch

from . import where


def constoprim(rho, mom):
    return mom / rho


def eos(rho, v):
    return 0.4 * rho * (1.0 + 0.5 * v * v)


def slope(qm, q0, qp):
    dl = q0 - qm
    dr = qp - q0
    return where(dl * dr > 0.0, 2.0 * dl * dr / (dl + dr + 1e-30), 0.0)


def trace(q0, s):
    return q0 - 0.5 * s, q0 + 0.5 * s


def riemann(qrL, qlR, pL, pR):
    return where(pL > pR, qrL, qlR)


def cmpflx(qs, ps):
    return qs * ps


def update(q0, fm, f0):
    return q0 - 0.05 * (f0 - fm)


#: Relative width of a tie between two pressures: the program's float32
#: pressure carries about 3e-7 of relative rounding (five operations), so
#: a choice between pressures closer than this is decided by rounding.
TIE_RTOL = 1e-5

#: Each body once per output point (the fused nest evaluates each once).
BODIES = {"constoprim": constoprim, "eos": eos, "slope": slope,
          "trace": trace, "riemann": riemann, "cmpflx": cmpflx,
          "update": update}


def forward(arrays: dict) -> dict:
    rho, mom = arrays["rho"], arrays["mom"]
    v = constoprim(rho, mom)
    p = eos(rho, v)
    s = torch.zeros_like(rho)
    s[:, 1:-1] = slope(v[:, :-2], v[:, 1:-1], v[:, 2:])
    ql, qr = trace(v, s)
    del s
    f = torch.zeros_like(rho)
    f[:, 1:-2] = cmpflx(riemann(qr[:, 1:-2], ql[:, 2:-1], p[:, 1:-2],
                                p[:, 2:-1]), p[:, 1:-2])
    del ql, qr, v, p
    rnew = torch.zeros_like(rho)
    rnew[:, 2:-2] = update(rho[:, 2:-2], f[:, 1:-3], f[:, 2:-2])
    return {"rnew": rnew}


def undecided(arrays: dict) -> dict:
    """``{output: bool mask}`` of the outputs whose value reads a Riemann
    choice between pressures that tie within :data:`TIE_RTOL`:
    ``rnew[i]`` reads the flux of interface ``i`` and of ``i - 1``."""
    rho, mom = arrays["rho"], arrays["mom"]
    p = eos(rho, constoprim(rho, mom))
    pl, pr = p[:, 1:-2], p[:, 2:-1]
    tie = (pl - pr).abs() <= TIE_RTOL * torch.maximum(pl.abs(), pr.abs())
    mask = torch.zeros(rho.shape, dtype=torch.bool, device=rho.device)
    mask[:, 1:-2] |= tie
    mask[:, 2:-1] |= tie
    return {"rnew": mask}
