"""The general load generator.

A traffic mix is a data file, ``traffic/<mix>.json``, which this module
reads: the loop (``loop``, a module of ``loops/``), the grid (``dims``,
the configuration's size symbols), how many seeded fields each caller
alternates between, and for a closed loop the clients and PlanServe's
settings.  Inputs come from the seed alone, made on the device by one
``torch.Generator`` in one large call per array (each input's ``draw``, a
module of ``draws/``), so every seed gives the same sizes and the same
arrivals, only other values.  A new loop or a new distribution is a new
module found by its name; the pieces every loop shares are here.
"""
from __future__ import annotations

import dataclasses
import json
import pathlib
import time

import torch

from . import draws

TRAFFIC_DIR = pathlib.Path(__file__).resolve().parent / "traffic"


def load_mix(name: str) -> dict:
    return json.loads((TRAFFIC_DIR / f"{name}.json").read_text())


def make_fields(config: dict, dims: dict, seed: int, callers: int,
                fields: int, device) -> list:
    """``[caller][field] -> {input: float32 tensor}`` from ``seed``: one
    generator on ``device``, drawn caller by caller, field by field, input
    by input (sorted by name)."""
    g = torch.Generator(device=device)
    g.manual_seed(seed % 2**63)
    out = []
    for _ in range(callers):
        row = []
        for _ in range(fields):
            row.append({
                name: draws.load(spec["draw"])(
                    g, tuple(dims[d] for d in spec["dims"]), device)
                for name, spec in sorted(config["inputs"].items())})
        out.append(row)
    return out


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@dataclasses.dataclass
class Window:
    """What one measured window did: calls or requests attempted and
    failed, those completed, the window's length on the host's clock,
    each request's latency and PlanServe's per-request ``stats`` (closed
    loop only), and the examples completed inside the traced
    sub-window."""
    attempted: int
    failed: int
    examples: int
    window_s: float
    latencies_ms: list | None = None
    stats: list | None = None
    trace_examples: int = 0


class Schedule:
    """A window of ``seconds`` from now and, with a tracer, its traced
    sub-window: that starts a quarter into the window and lasts half of
    it, counted from when the profiler has started, and the window lasts
    at least until it ends."""

    def __init__(self, seconds: float, tracer=None):
        self.seconds, self.tracer = seconds, tracer
        self.t0 = time.perf_counter()
        self.t_stop = self.t0 + seconds
        self.t_trace = self.t0 + seconds / 4 if tracer is not None else None
        self.tracing = False

    def more(self, started: bool) -> bool:
        """Whether to start another call or round (the first always
        starts); starts and stops the tracer on the way."""
        now = time.perf_counter()
        if self.t_trace is not None and now >= self.t_trace:
            if not self.tracing:
                self.tracer.start()
                self.tracing = True
                self.t_trace = self.tracer.t0 + self.seconds / 2
                self.t_stop = max(self.t_stop, self.t_trace)
            else:
                self.tracer.stop()
                self.tracing = False
                self.t_trace = None
        return not started or now < self.t_stop

    def close(self) -> None:
        """Stop the tracer if the window ended inside the sub-window."""
        if self.tracing:
            self.tracer.stop()
            self.tracing = False
