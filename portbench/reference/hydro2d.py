"""Plain reference of ``hydro2d``: one split step of HydroC's Godunov
scheme (HFAV paper, section 5.4), an x sweep along ``i`` and then a y
sweep along ``j`` on its result, as whole-array operations.

Four conserved variables ``rho, rhou, rhov, E``.  A sweep along the last
axis of its arrays: primitives and the equation of state at every cell;
limited slopes and the MUSCL-Hancock face states at ``[1, n - 1)``; the
two-shock Riemann solver (``NITER`` Newton iterations, a converged point
frozen) and its flux at the interfaces ``k + 1/2``, ``k in [1, n - 2)``;
the conservative update on ``[2, n - 2)``.  The y sweep is the same
operator on the transposed arrays with the momenta's roles swapped.  The
outputs ``rnew, unew, vnew, enew`` hold the step on ``j, i in [2, n - 2)``
and zero elsewhere.

The step is computed in blocks of :data:`BLOCK` output rows, each from
its rows and :data:`HALO` more on each side (the y sweep reaches two
rows each way), so that a 10,000 x 10,000 grid in float64 takes a few GB
beside its inputs and outputs.

The Riemann solver samples the wave fan on the sign of the star velocity
``u*`` (the left or the right state) and, at a shock, on the sign of its
speed: where either lies within :data:`TIE_RTOL` of the waves' speed
scale the program may take either side, and both are its answer.
:func:`undecided` marks the outputs that read such a choice.
"""
from __future__ import annotations

import torch

from . import where

GAMMA = 1.4
SMALLR = 1e-10
SMALLC = 1e-10
SMALLP = SMALLC * SMALLC / GAMMA
NITER = 10
PRECISION = 1e-6
SLOPE_TYPE = 1.0
DTDX = 0.8 / 12.0
ZEROL = -100.0 / DTDX
ZEROR = 100.0 / DTDX
PROJECT = 1.0
GAMMA6 = (GAMMA + 1.0) / (2.0 * GAMMA)
SMALLPP = SMALLR * SMALLP

#: Output rows a block computes, and the rows it reads past each side.
BLOCK = 512
HALO = 4
#: Relative width of a tie in the fan's sampling, as a share of the
#: interface's speed scale (``|ul| + |ur|`` and the two sound speeds):
#: the float32 program's ``u*`` and shock speed carry at most about 2e-7
#: of it in rounding (9e-8 and 1.8e-7 over 12 M interfaces of the
#: benchmark's draws), ten times less.
TIE_RTOL = 2e-6


def sqrt(x):
    """``torch.sqrt`` on tensors; one operation on the yardstick's
    counting scalars."""
    if isinstance(x, torch.Tensor):
        return torch.sqrt(x)
    return x * 1.0


def fabs(x):
    return where(x < 0.0, -x, x)


def vmax(a, b):
    return where(a > b, a, b)


def vmin(a, b):
    return where(a < b, a, b)


def constoprim(rho, mom_n, mom_t, e_tot):
    r = vmax(rho, SMALLR)
    u = mom_n / r
    v = mom_t / r
    eken = 0.5 * (u * u + v * v)
    e = e_tot / r - eken
    return r, u, v, e


def eos(r, e):
    p = (GAMMA - 1.0) * r * e
    p = vmax(p, r * SMALLP)
    c = sqrt(GAMMA * p / r)
    return p, c


def slope(qm, q0, qp):
    dlft = SLOPE_TYPE * (q0 - qm)
    drgt = SLOPE_TYPE * (qp - q0)
    dcen = 0.5 * (dlft + drgt) / SLOPE_TYPE
    slop = vmin(fabs(dlft), fabs(drgt))
    dlim = where(dlft * drgt <= 0.0, 0.0, slop)
    dq = vmin(dlim, fabs(dcen))
    return where(dcen > 0.0, dq, -dq)


def trace(r, u, v, p, c, dr, du, dv, dp):
    """``(m, q)``: the states at the cell's right face and at its left
    face, each ``(r, u, v, p)``."""
    csq = c * c
    alpham = 0.5 * (dp / (r * c) - du) * r / c
    alphap = 0.5 * (dp / (r * c) + du) * r / c
    alpha0r = dr - dp / csq
    alpha0v = dv
    spminus = where(u - c >= ZEROR, PROJECT, (u - c) * DTDX + 1.0)
    spplus = where(u + c >= ZEROR, PROJECT, (u + c) * DTDX + 1.0)
    spzero = where(u >= ZEROR, PROJECT, u * DTDX + 1.0)
    ap = -0.5 * spplus * alphap
    am = -0.5 * spminus * alpham
    azr = -0.5 * spzero * alpha0r
    azv = -0.5 * spzero * alpha0v
    qr_ = r + (ap + am + azr)
    qu = u + (ap - am) * c / r
    qv = v + azv
    qp = p + (ap + am) * csq
    spminus = where(u - c <= ZEROL, -PROJECT, (u - c) * DTDX - 1.0)
    spplus = where(u + c <= ZEROL, -PROJECT, (u + c) * DTDX - 1.0)
    spzero = where(u <= ZEROL, -PROJECT, u * DTDX - 1.0)
    ap = -0.5 * spplus * alphap
    am = -0.5 * spminus * alpham
    azr = -0.5 * spzero * alpha0r
    azv = -0.5 * spzero * alpha0v
    mr = r + (ap + am + azr)
    mu = u + (ap - am) * c / r
    mv = v + azv
    mp = p + (ap + am) * csq
    return mr, mu, mv, mp, qr_, qu, qv, qp


def _star(qlr, qlu, qlp, qrr, qru, qrp):
    """The floored states, their Lagrangian sound speeds squared, and the
    star pressure after the Newton iterations."""
    rl = vmax(qlr, SMALLR)
    pl = vmax(qlp, rl * SMALLP)
    rr = vmax(qrr, SMALLR)
    pr = vmax(qrp, rr * SMALLP)
    cl = GAMMA * pl * rl
    cr = GAMMA * pr * rr
    wl = sqrt(cl)
    wr = sqrt(cr)
    pstar = vmax(((wr * pl + wl * pr) + wl * wr * (qlu - qru)) / (wl + wr),
                 0.0)
    pstar, goon = _newton(pstar, pl, pr, cl, cr, qlu, qru)
    for _ in range(NITER - 1):
        pnew, more = _newton(pstar, pl, pr, cl, cr, qlu, qru)
        pstar = where(goon, pnew, pstar)
        goon = where(goon, more, goon)
    return rl, pl, rr, pr, cl, cr, pstar


def _newton(pstar, pl, pr, cl, cr, ul, ur):
    wwl = sqrt(cl * (1.0 + GAMMA6 * (pstar - pl) / pl))
    wwr = sqrt(cr * (1.0 + GAMMA6 * (pstar - pr) / pr))
    swwl = wwl * wwl
    swwr = wwr * wwr
    ql = 2.0 * wwl * swwl / (swwl + cl)
    qr = 2.0 * wwr * swwr / (swwr + cr)
    usl = ul - (pstar - pl) / wwl
    usr = ur + (pstar - pr) / wwr
    delp = vmax(qr * ql / (qr + ql) * (usl - usr), -pstar)
    pnew = pstar + delp
    return pnew, fabs(delp / (pnew + SMALLPP)) > PRECISION


def _fan(rl, ul, pl, rr, ur, pr, cl, cr, pstar):
    """``(left, ro, uo, po, rstar, ustar, spout, spin)``: the sampled
    side and the wave speeds of its fan."""
    wr = sqrt(cr * (1.0 + GAMMA6 * (pstar - pr) / pr))
    wl = sqrt(cl * (1.0 + GAMMA6 * (pstar - pl) / pl))
    ustar = 0.5 * (ul + (pl - pstar) / wl + ur - (pr - pstar) / wr)
    left = ustar > 0.0
    ro = where(left, rl, rr)
    uo = where(left, ul, ur)
    po = where(left, pl, pr)
    wo = where(left, wl, wr)
    co = vmax(SMALLC, sqrt(fabs(GAMMA * po / ro)))
    rstar = vmax(ro / (1.0 + ro * (po - pstar) / (wo * wo)), SMALLR)
    cstar = vmax(SMALLC, sqrt(fabs(GAMMA * pstar / rstar)))
    suo = where(left, uo, -uo)
    spout = co - suo
    spin = cstar - where(left, ustar, -ustar)
    ushock = wo / ro - suo
    shock = pstar >= po
    spin = where(shock, ushock, spin)
    spout = where(shock, ushock, spout)
    return left, ro, uo, po, rstar, ustar, spout, spin


def riemann(qlr, qlu, qlv, qlp, qrr, qru, qrv, qrp):
    """The Godunov state ``(r, u, v, p)`` between the left state ``ql*``
    and the right state ``qr*``."""
    rl, pl, rr, pr, cl, cr, pstar = _star(qlr, qlu, qlp, qrr, qru, qrp)
    left, ro, uo, po, rstar, ustar, spout, spin = _fan(
        rl, qlu, pl, rr, qru, pr, cl, cr, pstar)
    scr = vmax(spout - spin, SMALLC + fabs(spout + spin))
    frac = (1.0 + (spout + spin) / scr) * 0.5
    frac = vmax(0.0, vmin(1.0, frac))
    out = spout < 0.0
    star = spin > 0.0
    gr = where(out, ro, where(star, rstar,
                              frac * rstar + (1.0 - frac) * ro))
    gu = where(out, uo, where(star, ustar,
                              frac * ustar + (1.0 - frac) * uo))
    gp = where(out, po, where(star, pstar,
                              frac * pstar + (1.0 - frac) * po))
    gv = where(left, qlv, qrv)
    return gr, gu, gv, gp


def cmpflx(gr, gu, gv, gp):
    entho = 1.0 / (GAMMA - 1.0)
    mass = gr * gu
    f_n = mass * gu + gp
    f_t = mass * gv
    ekin = 0.5 * gr * (gu * gu + gv * gv)
    etot = gp * entho + ekin
    f_e = gu * (etot + gp)
    return mass, f_n, f_t, f_e


def update(rho, mom_n, mom_t, e_tot, fr_m, fn_m, ft_m, fe_m,
           fr, fn, ft, fe):
    return (rho + (fr_m - fr) * DTDX, mom_n + (fn_m - fn) * DTDX,
            mom_t + (ft_m - ft) * DTDX, e_tot + (fe_m - fe) * DTDX)


#: Each kernel evaluation of the step once (the program evaluates each
#: once per grid point): a sweep's ten, x then y.
BODIES = {f"{s}.{name}": fn for s in ("x", "y") for name, fn in (
    ("constoprim", constoprim), ("eos", eos), ("slope_r", slope),
    ("slope_u", slope), ("slope_v", slope), ("slope_p", slope),
    ("trace", trace), ("riemann", riemann), ("cmpflx", cmpflx),
    ("update", update))}


def _sweep(rho, mom_n, mom_t, e_tot, tie_mask: bool = False):
    """One sweep along the last axis of ``(rho, normal momentum,
    transverse momentum, E)``: the updated four on ``[2, n - 2)`` of that
    axis, and with ``tie_mask`` the interfaces ``k + 1/2``,
    ``k in [1, n - 2)``, whose fan sampling ties."""
    r, u, v, e = constoprim(rho, mom_n, mom_t, e_tot)
    p, c = eos(r, e)
    prim = (r, u, v, p)
    dq = [slope(q[..., :-2], q[..., 1:-1], q[..., 2:]) for q in prim]
    m_q = trace(*(q[..., 1:-1] for q in (*prim, c)), *dq)
    del dq, prim, r, u, v, p, c, e
    # interface k + 1/2: the right face of cell k (m) and the left face
    # of cell k + 1 (q); cell k sits at k - 1 of the traced rows
    ql = [m[..., :-1] for m in m_q[:4]]
    qr = [q[..., 1:] for q in m_q[4:]]
    del m_q
    if tie_mask:
        rl, pl, rr, pr, cl, cr, pstar = _star(ql[0], ql[1], ql[3], qr[0],
                                              qr[1], qr[3])
        left, ro, uo, po, rstar, ustar, spout, spin = _fan(
            rl, ql[1], pl, rr, qr[1], pr, cl, cr, pstar)
        scale = fabs(ql[1]) + fabs(qr[1]) + torch.sqrt(GAMMA * pl / rl) \
            + torch.sqrt(GAMMA * pr / rr)
        tol = TIE_RTOL * scale
        return (fabs(ustar) <= tol) | ((pstar >= po) & (fabs(spout) <= tol))
    f = cmpflx(*riemann(*ql, *qr))
    del ql, qr
    state = (rho, mom_n, mom_t, e_tot)
    return update(*(s[..., 2:-2] for s in state),
                  *(g[..., :-1] for g in f), *(g[..., 1:] for g in f))


def _blocks(n: int):
    """``(a, b, lo, hi)``: each block's output rows ``[a, b)`` and the
    rows ``[lo, hi)`` it reads."""
    for a in range(2, n - 2, BLOCK):
        b = min(a + BLOCK, n - 2)
        yield a, b, max(a - HALO, 0), min(b + HALO, n)


def _x_state(arrays: dict, lo: int, hi: int):
    rows = [arrays[k][lo:hi] for k in ("rho", "rhou", "rhov", "E")]
    return _sweep(*rows)


def forward(arrays: dict) -> dict:
    rho = arrays["rho"]
    nj, ni = rho.shape
    outs = {k: torch.zeros_like(rho) for k in ("rnew", "unew", "vnew",
                                               "enew")}
    for a, b, lo, hi in _blocks(nj):
        xr, xu, xv, xe = _x_state(arrays, lo, hi)
        # the y sweep along rows: normal momentum rhov
        yr, yv, yu, ye = _sweep(*(t.transpose(0, 1)
                                  for t in (xr, xv, xu, xe)))
        del xr, xu, xv, xe
        for k, t in zip(("rnew", "unew", "vnew", "enew"), (yr, yu, yv, ye)):
            t = t.transpose(0, 1)
            outs[k][a:b, 2:-2] = t[a - lo - 2:b - lo - 2]
    return outs


def undecided(arrays: dict) -> dict:
    """``{output: bool mask}``, the same for the four outputs: those that
    read a tied fan sampling.  An x interface ``(j, i + 1/2)`` sets the x
    sweep's cells ``i`` and ``i + 1`` of row ``j``, which the y sweep
    reads from rows ``j - 2 .. j + 2``; a y interface ``(j + 1/2, i)``
    sets the outputs of rows ``j`` and ``j + 1``."""
    rho = arrays["rho"]
    nj, ni = rho.shape
    mask = torch.zeros(rho.shape, dtype=torch.bool, device=rho.device)
    for a, b, lo, hi in _blocks(nj):
        rows = [arrays[k][lo:hi] for k in ("rho", "rhou", "rhov", "E")]
        xt = _sweep(*rows, tie_mask=True)          # (hi - lo, ni - 3)
        cells = torch.zeros((hi - lo, ni), dtype=torch.bool,
                            device=rho.device)
        cells[:, 1:-2] |= xt                        # cell k of k + 1/2
        cells[:, 2:-1] |= xt                        # cell k + 1
        reach = torch.zeros_like(cells)
        for d in range(-2, 3):
            s = slice(max(d, 0), hi - lo + min(d, 0))
            t = slice(max(-d, 0), hi - lo + min(-d, 0))
            reach[t] |= cells[s]
        xr, xu, xv, xe = _x_state(arrays, lo, hi)
        yt = _sweep(*(t.transpose(0, 1) for t in (xr, xv, xu, xe)),
                    tie_mask=True).transpose(0, 1)  # (hi - lo - 3, ni - 4)
        del xr, xu, xv, xe
        reach[1:-2, 2:-2] |= yt
        reach[2:-1, 2:-2] |= yt
        mask[a:b] = reach[a - lo:b - lo]
    mask[:, :2] = False
    mask[:, -2:] = False
    return {k: mask for k in ("rnew", "unew", "vnew", "enew")}
