"""``"march"``: one caller marches HydroC's time loop
(``repro_torch.core.hydroc.HydroC``: the Courant program and the x-y and
y-x steps through ``compile_program``, ``backend="auto"``) from the
start the configuration's draws make, step after step, each step's
output the next step's input.  Warm-up steps march too, so the window
goes on from where they end; the window ends on a whole pair of steps
(an even one, with its Courant reduction, and the odd one after it).
Nothing is read back to the host inside a step: the host synchronises
every ``N`` steps, ``N`` from a warm pair's time, so that about
``queue_s`` seconds of steps are queued at most.

Two kinds of judged example: the state at the start of the last pair
(its frame filled, and the step it starts on) against the state after
the pair (its frame filled) and the pair's ``dtdx``; and the start of
the march against the float64 totals of ``rho`` and ``E`` over the
interior of the final state, which the reflecting walls conserve."""
from __future__ import annotations

import time

import torch

from ..generator import Schedule, Window, sync

#: Warm-up pairs: the first builds the three programs' kernels, the
#: second is timed.
WARM_PAIRS = 2
OUTPUTS = ("rnew", "unew", "vnew", "enew")


class Loop:
    """One caller, HydroC's march, whole steps back to back."""

    def __init__(self, program, config: dict, mix: dict, fields: list,
                 device, dtype):
        from repro_torch.core.hydroc import HydroC
        self.device = device
        self.queue_s = float(mix.get("queue_s", 1.0))
        t0 = time.perf_counter()
        self.hc = HydroC(device=device, dtype=dtype)
        self.plan_ms = (time.perf_counter() - t0) * 1e3
        self.start = {k: v.to(dtype) for k, v in fields[0][0].items()}
        self.hc.start(self.start)
        self.every = 2
        self.last = None

    def pair(self) -> None:
        """One pair of steps; keeps the pair's start (filled in place by
        its first step), its step number and its ``dtdx``."""
        hc = self.hc
        start, nstep = hc.state, hc.nstep
        hc.step()
        dtdx = hc.dtdx
        hc.step()
        self.last = (start, nstep, dtdx)

    def warm(self) -> None:
        for i in range(WARM_PAIRS):
            sync(self.device)
            t0 = time.perf_counter()
            self.pair()
            sync(self.device)
        per_step = max((time.perf_counter() - t0) / 2, 1e-6)
        self.every = max(2, 2 * int(self.queue_s / per_step / 2))

    def window(self, seconds: float, tracer=None) -> Window:
        n = traced = 0
        sched = Schedule(seconds, tracer)
        while sched.more(n > 0):
            traced += 2 * sched.tracing
            self.pair()
            n += 2
            if n % self.every == 0:
                sync(self.device)
        sync(self.device)
        t_end = time.perf_counter()
        sched.close()
        return Window(attempted=n, failed=0, examples=n,
                      window_s=t_end - sched.t0, trace_examples=traced)

    def judged(self) -> list:
        start, nstep, dtdx = self.last
        end = self.hc.filled()
        pair_in = {**start, "nstep": torch.tensor(float(nstep))}
        pair_out = dict(zip(OUTPUTS, (end[k] for k in
                                      ("rho", "rhou", "rhov", "E"))))
        pair_out["dtdx"] = dtdx.reshape(1)
        totals = {
            "mass": end["rho"][2:-2, 2:-2].double().sum().reshape(1),
            "energy": end["E"][2:-2, 2:-2].double().sum().reshape(1)}
        return [(pair_in, pair_out), (dict(self.start), totals)]

    def close(self) -> None:
        self.hc = None
