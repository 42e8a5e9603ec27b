"""``"closed"``: ``clients`` callers of one PlanServe, each submitting
its own field, waiting for its result and submitting its next field, in
lock-step rounds, as an ensemble's members or a parameter study's runs
are stepped: one caller submits every client's field, waits for every
result and starts the next round.  The window closes with the round that
is running at its end."""
from __future__ import annotations

import sys
import time
import traceback

import torch

from ..generator import Schedule, Window


class Loop:
    """``clients`` callers in a closed loop through one PlanServe."""

    def __init__(self, program, config: dict, mix: dict, fields: list,
                 device, dtype):
        from repro_torch.serve.plans import PlanServe, request_sizes
        s = mix["serve"]
        self.device = device
        self.fields = fields
        self.name = config["program"]
        self.max_batch = s["max_batch"]
        kwargs = {} if dtype == torch.float32 else {"dtype": dtype}
        self.serve = PlanServe({self.name: program}, device=device,
                               max_batch=s["max_batch"],
                               max_wait_ms=s["max_wait_ms"],
                               quantum=s["quantum"], compile_kwargs=kwargs)
        sizes = request_sizes(program, fields[0][0])
        self.serve.prefill(self.name, sizes, batch=self.max_batch)
        self.plan_ms = self.serve.metrics.snapshot()["compiles"]["total_ms"]
        self.last: dict = {}

    def warm(self) -> None:
        """Every client's every field once, all in flight together."""
        for f in range(len(self.fields[0])):
            tickets = [self.serve.submit(self.name, row[f])
                       for row in self.fields]
            for t in tickets:
                t.result()

    def _request(self, c: int, f: int, errors: list):
        """Submit client ``c``'s field ``f``; returns the ticket, or None
        when the submission itself failed."""
        try:
            return self.serve.submit(self.name, self.fields[c][f])
        except Exception:  # a failed request is counted, not fatal
            errors.append(traceback.format_exc())
            return None

    def _outcome(self, c: int, f: int, ticket, t_s: float, errors: list):
        """Wait for ``ticket``; returns its record (submit time, done
        time, whether it succeeded, PlanServe's stats)."""
        out = stats = None
        if ticket is not None:
            try:
                out = ticket.result()
            except Exception:  # a failed request is counted, not fatal
                errors.append(traceback.format_exc())
            else:
                stats = ticket.stats
                self.last[c] = (f, out)
        return (t_s, time.perf_counter(), out is not None, stats)

    def window(self, seconds: float, tracer=None) -> Window:
        """Rounds: submit every client's next field, wait for every
        result, and start the next round; no round starts past the
        window's end."""
        records, errors = [], []
        k = traced = 0
        sched = Schedule(seconds, tracer)
        while sched.more(k > 0):
            f = k % len(self.fields[0])
            sent = []
            for c in range(len(self.fields)):
                t_s = time.perf_counter()
                sent.append((c, self._request(c, f, errors), t_s))
            for c, ticket, t_s in sent:
                rec = self._outcome(c, f, ticket, t_s, errors)
                records.append(rec)
                traced += sched.tracing and rec[2]
            k += 1
        sched.close()
        if errors:
            print(f"first failed request:\n{errors[0]}", file=sys.stderr,
                  flush=True)
        done = [r for r in records if r[2]]
        return Window(
            attempted=len(records), failed=len(records) - len(done),
            examples=len(done),
            window_s=max(r[1] for r in records) - sched.t0,
            latencies_ms=[(r[1] - r[0]) * 1e3 for r in records],
            stats=[r[3] for r in done], trace_examples=traced)

    def judged(self) -> list:
        """(inputs, outputs) of each client's last completed request."""
        return [(self.fields[c][f], out)
                for c, (f, out) in sorted(self.last.items())]

    def close(self) -> None:
        self.serve.close()
