"""HydroC's time loop on the port: the Courant program and the driver
that marches a state step after step.

HydroC (github.com/HydroBench/Hydro) advances its state by the split step
of :mod:`repro_torch.core.hydro2d` at a ``dt`` of its own:

* every second step (``nstep % 2 == 0``) it reduces the Courant number
  ``max over the interior of max(c + |u|, c + |v|)`` and sets ``dt =
  courant_factor * dx / max(courant, smallc)``, halved at step 0;
* even steps sweep x then y, odd steps y then x, at that ``dt``;
* before each sweep it fills the two-cell ghost frame from the interior:
  reflecting walls mirror the cells and negate the normal momentum.

:func:`courant_program` is the reduction, one ``kind="reduce"`` kernel
with a ``max`` combine over ``j, i in [2, n - 2)`` and a 0-dim host step
giving ``dtdx = courant_factor / max(courant, smallc)`` (``dx`` cancels:
the sweeps read ``dt / dx`` only).
:func:`~repro_torch.core.hydro2d.hydroc_program` is the split step
reading ``dtdx`` as a scalar input.  :class:`HydroC` compiles the
three programs (Courant, x-y, y-x) and marches: ``dtdx`` stays a device
tensor, the host keeps only the step's parity, and nothing is read back
to the host inside a step.

The fused x-y step is HydroC's x sweep, ghost refill, y sweep: the y
sweep reads the x-swept ghost rows, which the fused step computes from
the mirrored ghost rows of its input; the x sweep treats the transverse
momentum as a passive scalar, so an x-swept ghost row is the x-swept
interior row it mirrors with its ``rhov`` negated, which is what the
refill would write.
"""
from __future__ import annotations

import torch

from .. import obs
from .elementwise import where
from .hydro2d import (OUTPUTS, SMALLC, STATE, _constoprim, _eos,
                      hydroc_program)
from .rules import Program, axiom, goal, kernel

#: HydroC's Courant factor.
COURANT_FACTOR = 0.8
#: The ghost frame's width: two cells on each side.
FRAME = 2


def _courant_speed(rho, rhou, rhov, e_tot):
    r, u, v, e = _constoprim(rho, rhou, rhov, e_tot)
    _, c = _eos(r, e)
    cu = c + abs(u)
    cv = c + abs(v)
    return where(cu > cv, cu, cv)


def _courant_max(acc, x):
    return where(acc > x, acc, x)


def _courant_dtdx(courant):
    return COURANT_FACTOR / where(courant > SMALLC, courant, SMALLC)


def courant_program(name: str = "courant") -> Program:
    """HydroC's ``compute_deltat`` over ``(rho, rhou, rhov, E)``: the
    largest ``c + |u|`` or ``c + |v|`` of the interior ``j, i in
    [2, n - 2)``, folded by ``max``, and ``dtdx`` from it."""
    inner = {"j": ("Nj", FRAME, -FRAME), "i": ("Ni", FRAME, -FRAME)}
    return Program(
        rules=[
            kernel("courant_speed",
                   inputs=[(a, f"{a}[j?][i?]") for a in ("rho", "rhou",
                                                         "rhov", "E")],
                   outputs=[("s", "speed(rho[j?][i?])")],
                   fn=_courant_speed),
            kernel("courant_max", inputs=[("x", "speed(rho[j][i])")],
                   outputs=[("acc", "courant(rho)")], fn=_courant_max,
                   kind="reduce", init=0.0, within=inner),
            kernel("courant_dtdx", inputs=[("courant", "courant(rho)")],
                   outputs=[("dtdx", "dtdx(rho)")], fn=_courant_dtdx),
        ],
        axioms=[axiom(f"{a}[j?][i?]", j="Nj", i="Ni") for a in STATE],
        goals=[goal("dtdx(rho)", store_as="dtdx")],
        loop_order=("j", "i"),
        name=name,
    )


_FRAMES: dict = {}


def _frame(n: int, device) -> tuple:
    """(ghost indices, the interior indices each mirrors) along an axis
    of ``n`` cells: 0, 1 mirror 3, 2; n - 2, n - 1 mirror n - 3, n - 4."""
    key = (n, str(device))
    if key not in _FRAMES:
        _FRAMES[key] = (
            torch.tensor([0, 1, n - 2, n - 1], device=device),
            torch.tensor([3, 2, n - 3, n - 4], device=device))
    return _FRAMES[key]


def reflect(state: dict) -> dict:
    """Fill the ghost frame of ``state`` (``rho, rhou, rhov, E``, each
    ``(Nj, Ni)``) in place from its interior, as HydroC's reflecting
    walls do: each ghost cell mirrors the interior cell as far from the
    wall, the momentum normal to the wall negated (``rhov`` across the
    rows ``j``, ``rhou`` across the columns ``i``).  Rows first, whole
    rows, then whole columns: a corner is mirrored twice.  Returns
    ``state``."""
    nj, ni = state["rho"].shape
    dev = state["rho"].device
    for axis, n, normal in ((0, nj, "rhov"), (1, ni, "rhou")):
        dst, src = _frame(n, dev)
        for name in STATE:
            x = state[name]
            g = x.index_select(axis, src)
            x.index_copy_(axis, dst, g.neg_() if name == normal else g)
    return state


class HydroC:
    """HydroC's main loop over one state on one device.

    ``HydroC(device=..., dtype=...)`` compiles :func:`courant_program`
    and the x-y and y-x steps with :func:`compile_program` (``backend``
    ``"auto"``: K1 on the card).  :meth:`start` takes a state at step 0;
    each :meth:`step` refills the frame, on an even step reduces a new
    ``dtdx`` (halved at step 0) and sweeps x-y, on an odd one sweeps y-x
    at the same ``dtdx``, and makes the step's outputs the next state.
    Spans ``hydroc.step`` around ``hydroc.boundary``, ``hydroc.courant``
    and the programs' ``plan.run``; counters ``hydroc.steps`` and
    ``hydroc.courant``."""

    def __init__(self, *, device=None, dtype=torch.float32,
                 backend: str = "auto"):
        from .engine import compile_program

        def build(prog):
            return compile_program(prog, backend=backend, device=device,
                                   dtype=dtype).fn

        self.courant = build(courant_program())
        self.sweep = {"xy": build(hydroc_program()),
                      "yx": build(hydroc_program("hydroc_yx", "yx"))}
        self.state: dict | None = None
        self.dtdx = None
        self.nstep = 0

    def start(self, state: dict) -> None:
        """Take ``state`` (its arrays, not copies) as step 0's."""
        self.state = {k: state[k] for k in STATE}
        self.dtdx = None
        self.nstep = 0

    def filled(self) -> dict:
        """The current state, its frame filled (in place)."""
        return reflect(self.state)

    def step(self) -> None:
        """One step: the state becomes its outputs (their frame not yet
        filled)."""
        with obs.span("hydroc.step"):
            with obs.span("hydroc.boundary"):
                reflect(self.state)
            even = self.nstep % 2 == 0
            if even:
                with obs.span("hydroc.courant"):
                    dtdx = self.courant(**self.state)["dtdx"]
                    self.dtdx = dtdx * 0.5 if self.nstep == 0 else dtdx
                obs.count("hydroc.courant")
            out = self.sweep["xy" if even else "yx"](**self.state,
                                                     dtdx=self.dtdx)
            self.state = dict(zip(STATE, (out[k] for k in OUTPUTS)))
            self.nstep += 1
            obs.count("hydroc.steps")
