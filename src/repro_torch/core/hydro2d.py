"""Hydro2D's split step (HFAV paper, section 5.4) as one HFAV program.

The PRACE mini-app HydroC (github.com/HydroBench/Hydro), a 2-D cut of
RAMSES' Godunov solver, advances the Euler equations for an ideal gas in
four conserved variables, density ``rho``, momenta ``rhou`` (along
``i``) and ``rhov`` (along ``j``) and total energy ``E``, by a
dimensionally split step: an x sweep along ``i``, then a y sweep along
``j`` on the x sweep's result.  Each sweep is HydroC's chain of kernels,
written here with its constants and in its order:

* ``constoprim``: primitives ``(r, u, v, e)``, the density floored at
  ``SMALLR``, ``e`` the specific internal energy;
* ``equation_of_state``: pressure (floored at ``r * SMALLP``) and sound
  speed of a gamma-law gas;
* ``slope``: the limited slope of each primitive (``SLOPE_TYPE``);
* ``trace``: the MUSCL-Hancock states at a cell's two faces, half a step
  ahead (``iorder = 2``);
* ``riemann``: the exact two-shock solver, ``NITER_RIEMANN`` Newton
  iterations for the star pressure, a point that has converged frozen
  (HydroC's ``goon`` flag), then the sampling of the wave fan;
* ``cmpflx``: the Godunov flux of the interface state;
* ``update``: the conservative update, the transverse velocity advected
  passively.

A sweep's flux at interface ``i + 1/2`` is stored at ``i``; a cell reads
the fluxes at ``i - 1`` and ``i``, so the update reaches two cells each
way and the step's outputs cover ``j, i in [2, n - 2)``.  The y sweep
is the x sweep's operator with the roles of the momenta swapped: its
normal momentum is ``rhov``.

``hydro2d_program()`` reads ``dt / dx`` as the constant ``DTDX`` and
runs x then y; ``hydroc_program()`` reads it as the scalar input ``dtdx``
in either order, and :mod:`repro_torch.core.hydroc` marches it as
HydroC's main loop does (the Courant reduction every second step, the
orders alternating, the ghost frame refilled by reflection).  The
departures that remain: the ghost frame lies inside the arrays (two
cells a side, so an ``n x n`` array has an ``(n - 4) x (n - 4)``
interior), the fused x-y step computes the x sweep on the ghost rows
where HydroC refills them (the same values on a mirrored frame), and the
card computes in float32 where HydroC computes in double.  Every branch
of HydroC's routines is a ``where``, so every point evaluates the same
operations; their time still depends on the data (the card's IEEE
division is slower on some operands: a sweep of Sedov's blast takes
about 1.4x one of random states on an H100).
"""
from __future__ import annotations

from .elementwise import sqrt, where
from .rules import Program, axiom, goal, kernel

#: Ideal-gas ratio of specific heats and HydroC's floors.
GAMMA = 1.4
SMALLR = 1e-10
SMALLC = 1e-10
SMALLP = SMALLC * SMALLC / GAMMA
#: Newton iterations of the Riemann solver and their convergence bound.
NITER_RIEMANN = 10
PRECISION = 1e-6
SLOPE_TYPE = 1.0
#: ``dt / dx``: HydroC's Courant factor 0.8 over a bound of ``|u| + c``
#: under the benchmark's draws (``|u| <= 6``, ``c <= 6``), 12.
DTDX = 0.8 / 12.0
#: MUSCL-Hancock's trace: a characteristic is never projected out (its
#: bounds ``ZEROL``, ``ZEROR`` are ``-+100 / dtdx``).
PROJECT = 1.0

#: The conserved variables: the step's input arrays and its outputs.
STATE = ("rho", "rhou", "rhov", "E")
OUTPUTS = ("rnew", "unew", "vnew", "enew")


def _max(a, b):
    return where(a > b, a, b)


def _min(a, b):
    return where(a < b, a, b)


def _constoprim(rho, mom_n, mom_t, e_tot):
    r = _max(rho, SMALLR)
    u = mom_n / r
    v = mom_t / r
    eken = 0.5 * (u * u + v * v)
    e = e_tot / r - eken
    return r, u, v, e


def _eos(r, e):
    p = (GAMMA - 1.0) * r * e
    p = _max(p, r * SMALLP)
    c = sqrt(GAMMA * p / r)
    return p, c


def _slope(qm, q0, qp):
    dlft = SLOPE_TYPE * (q0 - qm)
    drgt = SLOPE_TYPE * (qp - q0)
    dcen = 0.5 * (dlft + drgt) / SLOPE_TYPE
    slop = _min(abs(dlft), abs(drgt))
    dlim = where(dlft * drgt <= 0.0, 0.0, slop)
    dq = _min(dlim, abs(dcen))
    return where(dcen > 0.0, dq, -dq)


def _trace(r, u, v, p, c, dr, du, dv, dp):
    """The states at the cell's right face (``m``: the left state of the
    interface to its right) and at its left face (``q``), at
    ``DTDX``."""
    return _trace_dt(r, u, v, p, c, dr, du, dv, dp, DTDX)


def _trace_dt(r, u, v, p, c, dr, du, dv, dp, dtdx):
    """:func:`_trace` at ``dtdx``, a value or the step's scalar input."""
    zerol = -100.0 / dtdx
    zeror = 100.0 / dtdx
    csq = c * c
    alpham = 0.5 * (dp / (r * c) - du) * r / c
    alphap = 0.5 * (dp / (r * c) + du) * r / c
    alpha0r = dr - dp / csq
    alpha0v = dv
    # the left face: the right state of the interface to the cell's left
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
    # the right face: the left state of the interface to the cell's right
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


def _newton(pstar, pl, pr, cl, cr, ul, ur):
    """One Newton step for the star pressure: the new pressure and
    whether the step moved it by more than ``PRECISION``."""
    gamma6 = (GAMMA + 1.0) / (2.0 * GAMMA)
    wwl = sqrt(cl * (1.0 + gamma6 * (pstar - pl) / pl))
    wwr = sqrt(cr * (1.0 + gamma6 * (pstar - pr) / pr))
    swwl = wwl * wwl
    swwr = wwr * wwr
    ql = 2.0 * wwl * swwl / (swwl + cl)
    qr = 2.0 * wwr * swwr / (swwr + cr)
    usl = ul - (pstar - pl) / wwl
    usr = ur + (pstar - pr) / wwr
    delp = _max(qr * ql / (qr + ql) * (usl - usr), -pstar)
    pnew = pstar + delp
    return pnew, abs(delp / (pnew + SMALLR * SMALLP)) > PRECISION


def _riemann(qlr, qlu, qlv, qlp, qrr, qru, qrv, qrp):
    """The Godunov state ``(r, u, v, p)`` at an interface between the
    left state ``ql*`` and the right state ``qr*``."""
    gamma6 = (GAMMA + 1.0) / (2.0 * GAMMA)
    rl = _max(qlr, SMALLR)
    ul = qlu
    pl = _max(qlp, rl * SMALLP)
    rr = _max(qrr, SMALLR)
    ur = qru
    pr = _max(qrp, rr * SMALLP)
    cl = GAMMA * pl * rl
    cr = GAMMA * pr * rr
    wl = sqrt(cl)
    wr = sqrt(cr)
    pstar = _max(((wr * pl + wl * pr) + wl * wr * (ul - ur)) / (wl + wr),
                 0.0)
    # the first iteration runs everywhere; later ones where the last
    # moved the pressure by more than PRECISION
    pstar, goon = _newton(pstar, pl, pr, cl, cr, ul, ur)
    for _ in range(NITER_RIEMANN - 1):
        pnew, more = _newton(pstar, pl, pr, cl, cr, ul, ur)
        pstar = where(goon, pnew, pstar)
        goon = where(goon, more, goon)
    wr = sqrt(cr * (1.0 + gamma6 * (pstar - pr) / pr))
    wl = sqrt(cl * (1.0 + gamma6 * (pstar - pl) / pl))
    ustar = 0.5 * (ul + (pl - pstar) / wl + ur - (pr - pstar) / wr)
    left = ustar > 0.0
    ro = where(left, rl, rr)
    uo = where(left, ul, ur)
    po = where(left, pl, pr)
    wo = where(left, wl, wr)
    co = _max(SMALLC, sqrt(abs(GAMMA * po / ro)))
    rstar = _max(ro / (1.0 + ro * (po - pstar) / (wo * wo)), SMALLR)
    cstar = _max(SMALLC, sqrt(abs(GAMMA * pstar / rstar)))
    # sgnm * uo and sgnm * ustar, sgnm = +1 on the left, -1 on the right
    suo = where(left, uo, -uo)
    spout = co - suo
    spin = cstar - where(left, ustar, -ustar)
    ushock = wo / ro - suo
    shock = pstar >= po
    spin = where(shock, ushock, spin)
    spout = where(shock, ushock, spout)
    scr = _max(spout - spin, SMALLC + abs(spout + spin))
    frac = (1.0 + (spout + spin) / scr) * 0.5
    frac = _max(0.0, _min(1.0, frac))
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


def _cmpflx(gr, gu, gv, gp):
    entho = 1.0 / (GAMMA - 1.0)
    mass = gr * gu
    f_n = mass * gu + gp
    f_t = mass * gv
    ekin = 0.5 * gr * (gu * gu + gv * gv)
    etot = gp * entho + ekin
    f_e = gu * (etot + gp)
    return mass, f_n, f_t, f_e


def _update(rho, mom_n, mom_t, e_tot, fr_m, fn_m, ft_m, fe_m,
            fr, fn, ft, fe):
    return _update_dt(rho, mom_n, mom_t, e_tot, fr_m, fn_m, ft_m, fe_m,
                      fr, fn, ft, fe, DTDX)


def _update_dt(rho, mom_n, mom_t, e_tot, fr_m, fn_m, ft_m, fe_m,
               fr, fn, ft, fe, dtdx):
    return (rho + (fr_m - fr) * dtdx, mom_n + (fn_m - fn) * dtdx,
            mom_t + (ft_m - ft) * dtdx, e_tot + (fe_m - fe) * dtdx)


def _at(term: str, axis: str, off: int) -> str:
    """``term`` (an expression over ``[j?][i?]``) displaced by ``off``
    along ``axis``."""
    if off == 0:
        return term
    sign = "+" if off > 0 else "-"
    return term.replace(f"{axis}?]", f"{axis}?{sign}{abs(off)}]")


def _sweep(s: str, axis: str, state: tuple, out: tuple,
           dtdx_input: bool = False) -> list:
    """The rules of one sweep along ``axis`` (``"i"`` or ``"j"``):
    ``state`` are the terms of ``(rho, normal momentum, transverse
    momentum, E)`` it reads, ``out`` the terms of what it writes, in
    that order.  Its locals are named ``<s>_<what>(rho[j?][i?])``.  With
    ``dtdx_input`` the trace and the update read ``dt / dx`` from the
    scalar input ``dtdx``."""
    def t(what):
        return f"{s}_{what}(rho[j?][i?])"

    dt = [("dtdx", "dtdx")] if dtdx_input else []
    trace, update = (_trace_dt, _update_dt) if dtdx_input \
        else (_trace, _update)

    prim = ("r", "u", "v", "p")
    rules = [
        kernel(f"{s}_constoprim",
               inputs=list(zip(("rho", "mom_n", "mom_t", "e_tot"), state)),
               outputs=[(w, t(w)) for w in ("r", "u", "v", "e")],
               fn=_constoprim),
        kernel(f"{s}_eos", inputs=[("r", t("r")), ("e", t("e"))],
               outputs=[("p", t("p")), ("c", t("c"))], fn=_eos),
    ]
    for w in prim:
        rules.append(kernel(
            f"{s}_slope_{w}",
            inputs=[(n, _at(t(w), axis, o))
                    for n, o in (("qm", -1), ("q0", 0), ("qp", 1))],
            outputs=[("dq", t("d" + w))], fn=_slope))
    rules += [
        kernel(f"{s}_trace",
               inputs=[(w, t(w)) for w in (*prim, "c")]
               + [("d" + w, t("d" + w)) for w in prim] + dt,
               outputs=[(f"{f}{w}", t(f"{f}{w}"))
                        for f in ("m", "q") for w in prim],
               fn=trace),
        # interface axis + 1/2: the right face of this cell (m) and the
        # left face of the next (q)
        kernel(f"{s}_riemann",
               inputs=[(f"ql{w}", t("m" + w)) for w in prim]
               + [(f"qr{w}", _at(t("q" + w), axis, 1)) for w in prim],
               outputs=[(f"g{w}", t("g" + w)) for w in prim],
               fn=_riemann),
        kernel(f"{s}_cmpflx", inputs=[(f"g{w}", t("g" + w)) for w in prim],
               outputs=[(f"f{w}", t("f" + w)) for w in prim],
               fn=_cmpflx),
        kernel(f"{s}_update",
               inputs=list(zip(("rho", "mom_n", "mom_t", "e_tot"), state))
               + [(f"f{w}m", _at(t("f" + w), axis, -1)) for w in prim]
               + [(f"f{w}", t("f" + w)) for w in prim] + dt,
               outputs=[(f"o{k}", o) for k, o in enumerate(out)],
               fn=update),
    ]
    return rules


def hydro2d_program(name: str = "hydro2d", order: str = "xy",
                    dtdx_input: bool = False) -> Program:
    """One split step: the x sweep on ``(rho, rhou, rhov, E)``, then the
    y sweep on its result (``order="yx"``: the y sweep first, HydroC's
    other half-step order); outputs ``rnew, unew, vnew, enew`` (density,
    the two momenta, total energy) on ``j, i in [2, n - 2)``.  ``dt /
    dx`` is :data:`DTDX`, or with ``dtdx_input`` the scalar input
    ``dtdx`` (a 0-dim array: the Courant program's output)."""
    if order not in ("xy", "yx"):
        raise ValueError(f"order is 'xy' or 'yx', not {order!r}")
    axis = {"x": "i", "y": "j"}
    first, second = order
    ins = {a: f"{a}[j?][i?]" for a in STATE}
    mid = {a: f"{first}_{a}(rho[j?][i?])" for a in STATE}
    outs = {a: f"{o}(rho[j?][i?])" for a, o in zip(STATE, OUTPUTS)}

    def sweep(s, src, dst):
        # the normal momentum is rhou along i, rhov along j
        n, t = ("rhou", "rhov") if s == "x" else ("rhov", "rhou")
        return _sweep(s, axis[s], (src["rho"], src[n], src[t], src["E"]),
                      (dst["rho"], dst[n], dst[t], dst["E"]), dtdx_input)

    return Program(
        rules=sweep(first, ins, mid) + sweep(second, mid, outs),
        axioms=[axiom(f"{a}[j?][i?]", j="Nj", i="Ni") for a in STATE]
        + ([axiom("dtdx")] if dtdx_input else []),
        goals=[goal(f"{o}(rho[j][i])", store_as=o,
                    j=("Nj", 2, -2), i=("Ni", 2, -2)) for o in OUTPUTS],
        loop_order=("j", "i"),
        name=name,
    )


def hydroc_program(name: str = "hydroc", order: str = "xy") -> Program:
    """HydroC's split step in ``order`` at the scalar input ``dtdx``
    (:mod:`repro_torch.core.hydroc` marches it)."""
    return hydro2d_program(name, order, dtdx_input=True)
