"""``"step"``: one caller applies the compiled program
(``compile_program``, ``backend="auto"``) to whole fields back to back,
alternating between its fields, with no synchronisation per step: the
host's dispatch runs ahead of the device, and the window ends at a
synchronisation."""
from __future__ import annotations

import time

from ..generator import Schedule, Window, sync


class Loop:
    """One caller, the compiled program, whole fields back to back."""

    def __init__(self, program, config: dict, mix: dict, fields: list,
                 device, dtype):
        from repro_torch.core import compile_program
        self.device = device
        self.fields = fields[0]
        t0 = time.perf_counter()
        self.gen = compile_program(program, device=device, dtype=dtype)
        self.plan_ms = (time.perf_counter() - t0) * 1e3
        self.last: dict = {}

    def warm(self) -> None:
        for _ in range(2):
            for f in self.fields:
                self.gen.fn(**f)
        sync(self.device)

    def window(self, seconds: float, tracer=None) -> Window:
        fields, fn = self.fields, self.gen.fn
        n = traced = 0
        sched = Schedule(seconds, tracer)
        while sched.more(n > 0):
            traced += sched.tracing
            i = n % len(fields)
            self.last[i] = fn(**fields[i])
            n += 1
        sync(self.device)
        t_end = time.perf_counter()
        sched.close()
        return Window(attempted=n, failed=0, examples=n,
                      window_s=t_end - sched.t0, trace_examples=traced)

    def judged(self) -> list:
        """(inputs, outputs) of the last call on each field."""
        return [(self.fields[i], out) for i, out in sorted(self.last.items())]

    def close(self) -> None:
        self.gen = None
