"""Plain reference of ``hydroc``: HydroC's time loop (github.com/HydroBench/
Hydro, its ``main`` as recalled) over one pair of steps, as whole-array
operations in blocks of rows.

A pair starts on an even step: the Courant number ``max over the interior
of max(c + |u|, c + |v|)`` gives ``dtdx = 0.8 / max(courant, smallc)``
(halved at step 0); the x-then-y split step at ``dtdx``; the ghost frame
refilled by reflection; the y-then-x split step at the same ``dtdx``; the
frame refilled again.  The split step is ``reference/hydro2d.py``'s, its
``dt / dx`` a parameter here: the trace (whose bounds ``-+100 / dtdx``
move with it) and the update are this module's own; constoprim, the
equation of state, the slopes, the Riemann solver and the flux are
``hydro2d``'s, which do not read ``dt``.  A y-then-x step is the x-then-y
step of the transposed state, its momenta swapped.  Reflecting walls
mirror each ghost cell from the interior cell as far from the wall and
negate the momentum normal to it; a corner is mirrored twice.

:func:`forward` answers two kinds of judged example:

* a pair (inputs ``rho, rhou, rhov, E`` with their frame filled, and
  ``nstep``, the step the pair starts on): the state after the pair,
  its frame filled (``rnew, unew, vnew, enew``), and the pair's ``dtdx``;
* the start of the march (the four arrays alone): their float64 totals
  of ``rho`` and ``E`` over the interior (``mass``, ``energy``), which
  the walls conserve, so that the program's totals after any number of
  steps are judged against them.

The departures from HydroC: the float64 here against HydroC's double is
none; the grid's frame lies inside its arrays (an ``n x n`` array has an
``(n - 4) x (n - 4)`` interior), and a corner ghost, which HydroC never
reads, is mirrored twice.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import hydro2d as h2
from . import where
from .hydro2d import (PROJECT, cmpflx, constoprim, eos, fabs, riemann,
                      slope, vmax)

COURANT_FACTOR = 0.8
SMALLC = h2.SMALLC
STATE = ("rho", "rhou", "rhov", "E")
OUTPUTS = ("rnew", "unew", "vnew", "enew")


def trace(r, u, v, p, c, dr, du, dv, dp, dtdx):
    """``(m, q)``: the states at the cell's right face and at its left
    face, each ``(r, u, v, p)``, half a step of ``dtdx`` ahead."""
    zerol = -100.0 / dtdx
    zeror = 100.0 / dtdx
    csq = c * c
    alpham = 0.5 * (dp / (r * c) - du) * r / c
    alphap = 0.5 * (dp / (r * c) + du) * r / c
    alpha0r = dr - dp / csq
    alpha0v = dv
    spminus = where(u - c >= zeror, PROJECT, (u - c) * dtdx + 1.0)
    spplus = where(u + c >= zeror, PROJECT, (u + c) * dtdx + 1.0)
    spzero = where(u >= zeror, PROJECT, u * dtdx + 1.0)
    ap = -0.5 * spplus * alphap
    am = -0.5 * spminus * alpham
    azr = -0.5 * spzero * alpha0r
    azv = -0.5 * spzero * alpha0v
    qr_ = r + (ap + am + azr)
    qu = u + (ap - am) * c / r
    qv = v + azv
    qp = p + (ap + am) * csq
    spminus = where(u - c <= zerol, -PROJECT, (u - c) * dtdx - 1.0)
    spplus = where(u + c <= zerol, -PROJECT, (u + c) * dtdx - 1.0)
    spzero = where(u <= zerol, -PROJECT, u * dtdx - 1.0)
    ap = -0.5 * spplus * alphap
    am = -0.5 * spminus * alpham
    azr = -0.5 * spzero * alpha0r
    azv = -0.5 * spzero * alpha0v
    mr = r + (ap + am + azr)
    mu = u + (ap - am) * c / r
    mv = v + azv
    mp = p + (ap + am) * csq
    return mr, mu, mv, mp, qr_, qu, qv, qp


def update(rho, mom_n, mom_t, e_tot, fr_m, fn_m, ft_m, fe_m,
           fr, fn, ft, fe, dtdx):
    return (rho + (fr_m - fr) * dtdx, mom_n + (fn_m - fn) * dtdx,
            mom_t + (ft_m - ft) * dtdx, e_tot + (fe_m - fe) * dtdx)


def courant_speed(rho, rhou, rhov, e_tot):
    """A cell's fastest signal along either axis, ``max(c + |u|,
    c + |v|)``."""
    r, u, v, e = constoprim(rho, rhou, rhov, e_tot)
    _, c = eos(r, e)
    return vmax(c + fabs(u), c + fabs(v))


#: Each kernel evaluation of one split step once (the program evaluates
#: each once per grid point): a sweep's ten, x then y.  The Courant
#: reduction, every second step, is counted by its bytes.
BODIES = {f"{s}.{name}": fn for s in ("x", "y") for name, fn in (
    ("constoprim", constoprim), ("eos", eos), ("slope_r", slope),
    ("slope_u", slope), ("slope_v", slope), ("slope_p", slope),
    ("trace", trace), ("riemann", riemann), ("cmpflx", cmpflx),
    ("update", update))}


def _sweep(rho, mom_n, mom_t, e_tot, dtdx, tie_mask: bool = False):
    """One sweep along the last axis at ``dtdx``: the updated four on
    ``[2, n - 2)`` of that axis, or with ``tie_mask`` the interfaces
    ``k + 1/2``, ``k in [1, n - 2)``, whose fan sampling ties between two
    states that differ other than as mirror images.  Where the states are
    equal (all of a uniform region), either side is the same answer; where
    they mirror each other (a reflecting wall), ``u* = 0`` and the solver
    takes the star state, the same from either side: the reflected shock
    or the rarefaction moves away from the wall on both."""
    r, u, v, e = constoprim(rho, mom_n, mom_t, e_tot)
    p, c = eos(r, e)
    prim = (r, u, v, p)
    dq = [slope(q[..., :-2], q[..., 1:-1], q[..., 2:]) for q in prim]
    m_q = trace(*(q[..., 1:-1] for q in (*prim, c)), *dq, dtdx)
    del dq, prim, r, u, v, p, c, e
    ql = [m[..., :-1] for m in m_q[:4]]
    qr = [q[..., 1:] for q in m_q[4:]]
    del m_q
    if tie_mask:
        rl, pl, rr, pr, cl, cr, pstar = h2._star(ql[0], ql[1], ql[3], qr[0],
                                                 qr[1], qr[3])
        left, ro, uo, po, rstar, ustar, spout, spin = h2._fan(
            rl, ql[1], pl, rr, qr[1], pr, cl, cr, pstar)
        scale = fabs(ql[1]) + fabs(qr[1]) + torch.sqrt(h2.GAMMA * pl / rl) \
            + torch.sqrt(h2.GAMMA * pr / rr)
        tol = h2.TIE_RTOL * scale
        tie = (fabs(ustar) <= tol) | ((pstar >= po) & (fabs(spout) <= tol))
        even = (ql[0] == qr[0]) & (ql[2] == qr[2]) & (ql[3] == qr[3])
        return tie & ~(even & ((ql[1] == qr[1]) | (ql[1] == -qr[1])))
    f = cmpflx(*riemann(*ql, *qr))
    del ql, qr
    state = (rho, mom_n, mom_t, e_tot)
    return update(*(s[..., 2:-2] for s in state),
                  *(g[..., :-1] for g in f), *(g[..., 1:] for g in f), dtdx)


def _x_state(arrays: dict, lo: int, hi: int, dtdx):
    return _sweep(*(arrays[k][lo:hi] for k in STATE), dtdx)


def _step_xy(arrays: dict, dtdx) -> dict:
    """The x-then-y split step: the four on ``[2, n - 2)``, zero in the
    frame."""
    rho = arrays["rho"]
    outs = {k: torch.zeros_like(rho) for k in STATE}
    for a, b, lo, hi in h2._blocks(rho.shape[0]):
        xr, xu, xv, xe = _x_state(arrays, lo, hi, dtdx)
        yr, yv, yu, ye = _sweep(*(t.transpose(0, 1)
                                  for t in (xr, xv, xu, xe)), dtdx)
        del xr, xu, xv, xe
        for k, t in zip(STATE, (yr, yu, yv, ye)):
            outs[k][a:b, 2:-2] = t.transpose(0, 1)[a - lo - 2:b - lo - 2]
    return outs


def _ties_xy(arrays: dict, dtdx) -> torch.Tensor:
    """The x-then-y step's outputs that read a tied fan sampling (as
    ``reference/hydro2d.py``'s ``undecided``)."""
    rho = arrays["rho"]
    nj, ni = rho.shape
    mask = torch.zeros(rho.shape, dtype=torch.bool, device=rho.device)
    for a, b, lo, hi in h2._blocks(nj):
        rows = [arrays[k][lo:hi] for k in STATE]
        xt = _sweep(*rows, dtdx, tie_mask=True)
        cells = torch.zeros((hi - lo, ni), dtype=torch.bool,
                            device=rho.device)
        cells[:, 1:-2] |= xt
        cells[:, 2:-1] |= xt
        reach = torch.zeros_like(cells)
        for d in range(-2, 3):
            s = slice(max(d, 0), hi - lo + min(d, 0))
            t = slice(max(-d, 0), hi - lo + min(-d, 0))
            reach[t] |= cells[s]
        xr, xu, xv, xe = _x_state(arrays, lo, hi, dtdx)
        yt = _sweep(*(t.transpose(0, 1) for t in (xr, xv, xu, xe)), dtdx,
                    tie_mask=True).transpose(0, 1)
        del xr, xu, xv, xe
        reach[1:-2, 2:-2] |= yt
        reach[2:-1, 2:-2] |= yt
        mask[a:b] = reach[a - lo:b - lo]
    mask[:, :2] = False
    mask[:, -2:] = False
    return mask


def _swapped(arrays: dict) -> dict:
    """The transposed state, its momenta swapped (the y axis as x)."""
    return {"rho": arrays["rho"].T.contiguous(),
            "rhou": arrays["rhov"].T.contiguous(),
            "rhov": arrays["rhou"].T.contiguous(),
            "E": arrays["E"].T.contiguous()}


def step(arrays: dict, dtdx, order: str) -> dict:
    """One split step in ``order`` (``"xy"`` or ``"yx"``) at ``dtdx``."""
    if order == "xy":
        return _step_xy(arrays, dtdx)
    return _swapped(_step_xy(_swapped(arrays), dtdx))


def ties(arrays: dict, dtdx, order: str) -> torch.Tensor:
    if order == "xy":
        return _ties_xy(arrays, dtdx)
    return _ties_xy(_swapped(arrays), dtdx).T.contiguous()


def reflect(arrays: dict, negate: bool = True) -> dict:
    """Fill the two-cell frame of each array in place from the interior:
    ghost rows ``0, 1, n - 2, n - 1`` mirror rows ``3, 2, n - 3, n - 4``
    (``rhov`` negated), then ghost columns likewise (``rhou`` negated),
    whole rows and columns, so a corner is mirrored twice."""
    for axis, normal in ((0, "rhov"), (1, "rhou")):
        for k, x in arrays.items():
            v = x if axis == 0 else x.transpose(0, 1)
            n = v.shape[0]
            top, bottom = v[2:4].flip(0), v[n - 4:n - 2].flip(0)
            if negate and k == normal:
                top, bottom = -top, -bottom
            v[0:2] = top
            v[n - 2:n] = bottom
    return arrays


def courant(arrays: dict) -> torch.Tensor:
    """``max(c + |u|, c + |v|)`` over the interior ``j, i in
    [2, n - 2)``."""
    nj = arrays["rho"].shape[0]
    best = None
    for a in range(2, nj - 2, h2.BLOCK):
        b = min(a + h2.BLOCK, nj - 2)
        m = courant_speed(*(arrays[k][a:b, 2:-2] for k in STATE)).max()
        best = m if best is None else torch.maximum(best, m)
    return best


def dtdx_of(arrays: dict, nstep: int) -> torch.Tensor:
    d = COURANT_FACTOR / torch.clamp(courant(arrays), min=SMALLC)
    return d * 0.5 if nstep == 0 else d


def pair(arrays: dict, nstep: int):
    """``(state after the pair, frame filled; the pair's dtdx)``."""
    dtdx = dtdx_of(arrays, nstep)
    mid = reflect(step(arrays, dtdx, "xy"))
    return reflect(step(mid, dtdx, "yx")), dtdx


def totals(arrays: dict) -> dict:
    """float64 totals of ``rho`` and ``E`` over the interior."""
    return {"mass": arrays["rho"][2:-2, 2:-2].double().sum().reshape(1),
            "energy": arrays["E"][2:-2, 2:-2].double().sum().reshape(1)}


def forward(arrays: dict) -> dict:
    state = {k: arrays[k] for k in STATE}
    if "nstep" not in arrays:
        return totals(state)
    end, dtdx = pair(state, int(arrays["nstep"]))
    out = {o: end[k] for o, k in zip(OUTPUTS, STATE)}
    out["dtdx"] = dtdx.reshape(1)
    return out


def _dilate(mask: torch.Tensor) -> torch.Tensor:
    """The cells within two rows and two columns of a marked one: those a
    split step's outputs read."""
    m = mask[None, None].to(torch.float32)
    return F.max_pool2d(m, 5, stride=1, padding=2)[0, 0] > 0


def undecided(arrays: dict) -> dict:
    """For a pair, ``{output: bool mask}`` of the state's cells that read
    a tied fan sampling: the first step's ties, mirrored into the frame
    and carried by the second step two cells each way, and the second
    step's own, mirrored into the frame; none for the totals."""
    if "nstep" not in arrays:
        return {}
    state = {k: arrays[k] for k in STATE}
    dtdx = dtdx_of(state, int(arrays["nstep"]))
    first = ties(state, dtdx, "xy")
    mid = reflect(step(state, dtdx, "xy"))
    mask = _dilate(reflect({"m": first}, negate=False)["m"])
    mask[:2] = mask[-2:] = False
    mask[:, :2] = mask[:, -2:] = False
    mask |= ties(mid, dtdx, "yx")
    del mid
    mask = reflect({"m": mask}, negate=False)["m"]
    return {o: mask for o in OUTPUTS}
