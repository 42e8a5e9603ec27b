"""The traced sub-window put down to the port's spans
(``repro_torch.obs``): each device operation to the span open on the
thread that launched it when it was launched, each idle instant to what
the host was doing then, and the per-layer readings taken from that.

* **Clocks.** Spans are on ``time.time_ns()``.  The profiler's host
  events (the CUDA runtime's calls) drift from it by tens of
  microseconds over a sub-window, so the tracer brackets a few
  ``cudaStreamQuery`` calls with ``time.time_ns()`` as the sub-window
  starts and as it ends, and maps host events onto spans' clock by the
  line through the two offsets.  The profiler's device timestamps drift
  from its host events by milliseconds, so device time is put on the
  host's clock gap by gap: an idle gap ends when the operation ending it
  was launched (the device waited for that launch), and the sub-window's
  tail, the idle time left over, ends with the sub-window.
* **Device time by span.** A device operation and the runtime call that
  launched it carry one correlation id; the call's time and thread name
  the innermost span open there.  Operations whose launch event is
  missing read ``(no launch event)``, those launched outside every span
  ``(caller)``.  A launch call that does not end inside its span counts
  as a clock violation.
* **Idle by span.** An idle instant inside a ``host.gc`` span (on any
  thread) is the collector's; any other goes to the innermost span open
  then on the thread that launched the operation ending the gap (the one
  that ended the last gap, for the sub-window's tail), or ``(caller)``.

The harness's own ``Tracer`` keeps device intervals only, and the harness
does not turn spans on, so until the benchmark reads spans itself this
module runs one traced run of a cell with spans on, through the harness,
from the root of a checkout:

    python3 -m portbench.spans --workload <cell> --seed <n> --seconds <s>

and prints the harness's result line with ``breakdown`` extended by
``device_by_span``, ``idle_by_span``, ``host_by_span`` (each span's self
time on the host, every thread) and ``counters``, each idle gap
labelled with its span, and ``spans``: the readings below and the
attribution's own checks.  Against a port without ``repro_torch.obs``
it prints the harness's line alone.
"""
from __future__ import annotations

import bisect
import dataclasses
import json
import pathlib
import sys
import time

import numpy as np

if __name__ == "__main__":  # the port's package from the checkout's src/
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]
                           / "src"))

try:
    from repro_torch import obs
except ImportError:  # a port without spans: nothing to put down
    obs = None

import torch

from . import trace

CALLER = "(caller)"
NO_LAUNCH = "(no launch event)"
GC = "host.gc"
#: Spans in which the batcher waits for callers or for a batch to fill.
WAIT = ("serve.wait", "serve.collect")
#: The runtime call the tracer's clock marks make (and the loops never).
MARK = "cudaStreamQuery"


def device_ops(prof) -> list:
    """``(start_ns, end_ns, name, correlation id)`` of every device
    operation of a profile."""
    out = []
    for e in prof.profiler.kineto_results.events():
        if str(e.device_type()).endswith("CUDA"):
            s = e.start_ns()
            out.append((s, s + e.duration_ns(), e.name(), e.correlation_id()))
    return out


def thread_key(tid: int) -> int:
    """The low 32 bits of a thread's ``pthread_self()``: what a CUDA
    runtime call's event and a span (``threading.get_ident()``) share."""
    return tid & 0xFFFFFFFF


def runtime_calls(prof) -> list:
    """``(name, start_ns, end_ns, correlation id, thread key)`` of the
    CUDA runtime's and driver's calls of a profile (host events named
    ``cuda*``/``cu*``; others, such as CUPTI's ``Command Buffer Full``,
    may carry a launch's correlation id too).  CUPTI names a call's
    thread by ``pthread_self()``, which the profiler hands on, cut to 32
    bits, as ``device_resource_id()``."""
    out = []
    for e in prof.profiler.kineto_results.events():
        if not str(e.device_type()).endswith("CUDA") and \
                e.name().startswith("cu"):
            s = e.start_ns()
            out.append((e.name(), s, s + e.duration_ns(), e.correlation_id(),
                        thread_key(e.device_resource_id())))
    return out


def host_offsets(calls: list, start: list, stop: list) -> list:
    """``[(t, offset)]``: at profiler time ``t`` the profiler's host clock
    reads ``offset`` ns past ``time.time_ns()``, once for the marks
    ``start`` and once for ``stop``.  A mark ``(a, b)`` brackets one
    :data:`MARK` call on ``time.time_ns()``, the calls of the profile in
    the same order; a call starts at least ``offset`` past ``a``, so each
    group's offset is its least ``start - a``.  Empty when the calls and
    the marks do not match."""
    events = sorted(s for name, s, _, _, _ in calls if name == MARK)
    if len(events) != len(start) + len(stop):
        return []
    out = []
    for marks, evs in ((start, events[:len(start)]),
                       (stop, events[len(start):])):
        if marks:
            out.append(min(((e, e - a) for (a, _), e in zip(marks, evs)),
                           key=lambda pair: pair[1]))
    return out


def to_span_clock(t: int, offsets: list) -> int:
    """Profiler host time ``t`` on ``time.time_ns()``: less the offset on
    the line through ``offsets`` (constant with one, none without)."""
    if not offsets:
        return t
    (t0, o0), (t1, o1) = offsets[0], offsets[-1]
    o = o0 if t1 == t0 else o0 + (o1 - o0) * (t - t0) / (t1 - t0)
    return t - round(o)


def launch_events(calls: list, offsets: list = ()) -> dict:
    """``{correlation id: (start_ns, end_ns, thread key)}`` of the calls
    that carry a correlation id, their times on ``time.time_ns()``."""
    return {c: (to_span_clock(s, offsets), to_span_clock(e, offsets), key)
            for _, s, e, c, key in calls if c}


class Innermost:
    """The innermost span open at an instant on a thread."""

    def __init__(self, spans):
        self.spans = spans
        by_tid: dict = {}
        for i in sorted(range(len(spans)), key=lambda i: spans.start[i]):
            by_tid.setdefault(thread_key(int(spans.tid[i])), []).append(i)
        self.index = by_tid
        self.starts = {t: [int(spans.start[i]) for i in ix]
                       for t, ix in by_tid.items()}

    def at(self, tid: int, t: int) -> int:
        """The span's index, or -1, on the thread of :func:`thread_key`
        ``tid``.  Spans of a thread nest, so it is the latest span opened
        by ``t`` or one of the spans around it."""
        starts = self.starts.get(tid)
        if not starts:
            return -1
        k = bisect.bisect_right(starts, t) - 1
        i = self.index[tid][k] if k >= 0 else -1
        while i >= 0 and self.spans.end[i] <= t:
            i = int(self.spans.parent[i])
        return i

    def next_start(self, tid: int, t: int) -> int:
        """The start of the first span opened after ``t`` on ``tid``."""
        starts = self.starts.get(tid, [])
        k = bisect.bisect_right(starts, t)
        return starts[k] if k < len(starts) else obs.OPEN


@dataclasses.dataclass
class Attribution:
    """Seconds of device time and of idle time by span (or by
    :data:`CALLER`, :data:`NO_LAUNCH`), the longest idle gaps labelled
    ``"<span> | <op> -> <op>"``, and the checks: device time whose launch
    event was found, device time put down to a span, launch calls that do
    not end inside their span (``violations``), and how far the device's
    timestamps drifted from the host's between the first gap and the last
    (``device_drift_s``)."""
    device_by_span: dict
    idle_by_span: dict
    gaps: list
    device_s: float
    launched_s: float
    spanned_s: float
    violations: int
    window_s: float
    device_drift_s: float = 0.0


def _add(d: dict, key: str, ns: int) -> None:
    d[key] = d.get(key, 0.0) + ns * 1e-9


def _busy(ops) -> list:
    """The union of the operations as runs ``[start, end, the op that
    ends it, the op that starts it]`` (indices of ``ops``), in order, on
    the device's clock."""
    runs = []
    for k in sorted(range(len(ops)), key=lambda k: ops[k][0]):
        s, e = ops[k][0], ops[k][1]
        if runs and s <= runs[-1][1]:
            if e >= runs[-1][1]:
                runs[-1][1], runs[-1][2] = e, k
        else:
            runs.append([s, e, k, k])
    return runs


def _merged(intervals) -> list:
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _minus(a: int, b: int, cuts: list) -> list:
    """``[a, b)`` less the sorted, merged intervals ``cuts``."""
    out, t = [], a
    for s, e in cuts:
        if e <= t or s >= b:
            continue
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if t < b:
        out.append((t, b))
    return out


def _longest_call(calls: list, a: int, b: int):
    """The call of ``calls`` (``(start, end, name)`` sorted by start, one
    thread's, none longer than a second) that overlaps ``[a, b)`` most,
    as ``(overlap, name)``."""
    best = (0, None)
    lo = bisect.bisect_left(calls, (a - 10**9,))
    for s, e, name in calls[lo:bisect.bisect_left(calls, (b,))]:
        best = max(best, (min(b, e) - max(a, s), name))
    return best


def attribute(ops, launches: dict, spans, w0: int, w1: int,
              calls: list = ()) -> Attribution:
    """Put the device operations ``ops`` (:func:`device_ops`) and the
    idle instants of ``[w0, w1)`` down to ``spans`` (``obs.Spans``),
    through ``launches`` (:func:`launch_events`); ``w0``, ``w1`` and the
    launches on ``time.time_ns()``.  A labelled gap names, after its
    span, the runtime call of ``calls`` (``(name, start, end, thread
    key)``, on ``time.time_ns()``) that covers most of it on the
    launching thread, where that is a tenth of it or more (a
    ``cudaMalloc``, say)."""
    inner = Innermost(spans)
    name = spans.label
    by_span: dict = {}
    launched = spanned = total = 0
    violations = 0
    for s, e, _, corr in ops:
        total += e - s
        hit = launches.get(corr)
        if hit is None:
            _add(by_span, NO_LAUNCH, e - s)
            continue
        launched += e - s
        i = inner.at(hit[2], hit[0])
        if i < 0:
            _add(by_span, CALLER, e - s)
            continue
        spanned += e - s
        violations += hit[1] > spans.end[i]
        _add(by_span, name(i), e - s)

    # the gaps on the host's clock: each ends where the op ending it was
    # launched; the tail is the idle time left over, before w1
    cuts = _merged((int(spans.start[i]), int(spans.end[i]))
                   for i in range(len(spans)) if name(i) == GC)
    gaps = []  # (host start or None, host end or length, before, after, key)
    first = offset = key = None
    t_dev = last = None
    runs = _busy(ops)
    for s, e, k_last, k_first in runs:
        hit = launches.get(ops[k_first][3])
        if hit is not None:
            offset, key = s - hit[0], hit[2]
            first = offset if first is None else first
            a = w0 if t_dev is None else hit[0] - (s - t_dev)
            gaps.append((max(a, w0), min(hit[0], w1), last, k_first, key))
        elif t_dev is not None:
            gaps.append((None, s - t_dev, last, k_first, None))
        t_dev, last = e, k_last
    busy = sum(e - s for s, e, _, _ in runs)
    placed = sum(b if a is None else max(b - a, 0) for a, b, *_ in gaps)
    tail = (w1 - w0) - busy - placed
    if t_dev is not None and tail > 0:
        gaps.append((w1 - tail, w1, last, None, key))

    idle: dict = {}
    labelled = []
    for a, b, before, after, key in gaps:
        mine: dict = {}
        if a is None:  # no launch event to put the gap on the host clock
            _add(mine, NO_LAUNCH, b)
            length = b
        elif b <= a:
            continue
        else:
            length = b - a
            for s, e in cuts:
                ov = min(b, e) - max(a, s)
                if ov > 0:
                    _add(mine, GC, ov)
            for p, q in _minus(a, b, cuts):
                t = p
                while t < q:
                    i = inner.at(key, t)
                    stop = min(q, inner.next_start(key, t))
                    if i >= 0:
                        stop = min(stop, int(spans.end[i]))
                    _add(mine, name(i) if i >= 0 else CALLER, stop - t)
                    t = stop
        for k, v in mine.items():
            idle[k] = idle.get(k, 0.0) + v
        ops_label = " -> ".join(trace._short(ops[j][2]) if j is not None
                                else "(window edge)" for j in (before, after))
        top = max(mine, key=mine.get)
        labelled.append([length * 1e-9, top, ops_label, a, b, key])
    labelled.sort(key=lambda g: -g[0])
    by_key: dict = {}
    for name_, s, e, k in calls:
        by_key.setdefault(k, []).append((s, e, name_))
    for v in by_key.values():
        v.sort()
    for g in labelled[:trace.TOP]:
        secs, top, ops_label, a, b, key = g
        over, call = (_longest_call(by_key.get(key, []), a, b)
                      if a is not None else (0, None))
        if call is not None and over * 10 >= b - a:
            top = f"{top} [{call} {over * 1e-9:.6f} s]"
        g[:] = [f"{top} | {ops_label}", secs]
    drift = (offset - first) * 1e-9 if first is not None else 0.0
    return Attribution(device_by_span=by_span, idle_by_span=idle,
                       gaps=labelled[:trace.TOP], device_s=total * 1e-9,
                       launched_s=launched * 1e-9, spanned_s=spanned * 1e-9,
                       violations=int(violations), window_s=(w1 - w0) * 1e-9,
                       device_drift_s=drift)


def host_by_span(spans, w0: int, w1: int) -> dict:
    """Seconds of host time inside ``[w0, w1)`` by span name, each span's
    self time (its own less its children's), summed over the threads."""
    dur = np.clip(spans.end, w0, w1) - np.clip(spans.start, w0, w1)
    own = dur.astype(np.float64)
    inner = spans.parent >= 0
    np.subtract.at(own, spans.parent[inner], dur[inner])
    by = np.bincount(spans.name, weights=own, minlength=len(spans.names))
    return {n: float(v) * 1e-9 for n, v in zip(spans.names, by) if v > 0}


def compile_ms(spans) -> float | None:
    """Host time of the compiles among ``spans``: each ``engine.compile``
    span not inside another (``compile_batched`` opens one around
    ``compile_program``'s), closed ones only; None without any."""
    ms = None
    for i in range(len(spans)):
        p = int(spans.parent[i])
        if spans.label(i) != "engine.compile" or spans.end[i] == obs.OPEN or \
                (p >= 0 and spans.label(p) == "engine.compile"):
            continue
        ms = (ms or 0.0) + (spans.end[i] - spans.start[i]) * 1e-6
    return ms


def readings(att: Attribution | None, counters: dict, examples: int,
             setup) -> dict:
    """The per-layer readings of a traced run with spans on: device time
    under the re-seat, the pad, the stack and the unpad per example (us),
    K1 launches per example, the shares (%) of the sub-window idle while
    the batcher waits (``serve.wait``, ``serve.collect``) and while
    another port span is open (``host.gc`` included), and the set-up's
    compile time (ms).  A reading with nothing to read is None."""
    out = {"compile_ms": compile_ms(setup) if setup is not None else None}
    per = ("reseat_us", "plan.reseat"), ("pad_us", "serve.pad"), \
        ("stack_us", "serve.stack"), ("unpad_us", "serve.unpad")
    for key, span in per:
        v = att.device_by_span.get(span) if att and examples > 0 else None
        out[key] = v / examples * 1e6 if v is not None else None
    out["k1_launches"] = (counters["k1.launch"] / examples
                          if "k1.launch" in counters and examples > 0
                          else None)
    idle = att.idle_by_span if att and att.device_s > 0 else {}
    window = att.window_s if att else 0.0
    waits = [v for k, v in idle.items() if k in WAIT]
    out["idle_wait_share"] = sum(waits) / window * 100 if waits else None
    other = [v for k, v in idle.items()
             if k not in WAIT and k not in (CALLER, NO_LAUNCH)]
    out["idle_dispatch_share"] = (sum(other) / window * 100
                                  if idle else None)
    out["idle_caller_share"] = (idle.get(CALLER, 0.0) / window * 100
                                if idle else None)
    return out


class SpanTracer(trace.Tracer):
    """The harness's tracer, which also drains the port's spans and
    counters at :meth:`start` and :meth:`stop`, brackets a few
    :data:`MARK` calls with ``time.time_ns()`` at each (the marks that
    put the profiler's host clock on the spans'), and puts the sub-window
    down to the spans (:attr:`attribution`, None without spans or a
    device)."""

    #: Clock marks at each end of the sub-window.
    MARKS = 5

    def __init__(self, device):
        super().__init__(device)
        self.head = self.tail = self.attribution = self.last = None
        self.spans = None
        self.w0 = self.w1 = None
        self.marks = {}
        self.offsets = []

    def _mark(self, end: str) -> None:
        marks = self.marks[end] = []
        if self.device.type == "cuda":
            stream = torch.cuda.current_stream(self.device)
            for _ in range(self.MARKS):
                a = time.time_ns()
                stream.query()
                marks.append((a, time.time_ns()))

    def start(self) -> None:
        self.head = obs.drain() if obs is not None else None
        super().start()
        self.w0 = time.time_ns()
        self._mark("start")

    def stop(self) -> None:
        self._mark("stop")
        super().stop()
        # the end on the spans' clock, at the harness's own t1
        self.w1 = self.w0 + round((self.t1 - self.t0) * 1e9)
        self.tail = obs.drain() if obs is not None else None

    def counters(self) -> dict:
        """Each counter's growth over the sub-window."""
        if self.head is None:
            return {}
        c0 = self.head.counters
        return {k: v - c0.get(k, 0) for k, v in self.tail.counters.items()}

    def summary(self):
        self.last = super().summary()
        if self.head is not None and self.device.type == "cuda":
            calls = runtime_calls(self.prof)
            self.offsets = host_offsets(calls, self.marks["start"],
                                        self.marks["stop"])
            self.spans = obs.pair(self.head, self.tail)
            on_clock = [(n, to_span_clock(s, self.offsets),
                         to_span_clock(e, self.offsets), k)
                        for n, s, e, _, k in calls]
            self.attribution = attribute(
                device_ops(self.prof), launch_events(calls, self.offsets),
                self.spans, self.w0, self.w1, on_clock)
        return self.last


def extend(line: dict, tracer: SpanTracer | None) -> dict:
    """The result line with the spans' breakdown and readings added; the
    line as it was without spans."""
    if tracer is None or tracer.head is None:
        return line
    att = tracer.attribution
    setup = obs.pair(tracer.head)
    values = readings(att, tracer.counters(), tracer.last.examples, setup)
    bd = line.setdefault("breakdown", {})
    bd["counters"] = tracer.counters()
    extra = {"overflow": tracer.head.overflow + tracer.tail.overflow}
    if att is not None:
        bd["device_by_span"] = att.device_by_span
        bd["idle_by_span"] = att.idle_by_span
        bd["host_by_span"] = host_by_span(tracer.spans, tracer.w0,
                                          tracer.w1)
        if att.gaps:
            bd["idle_gaps"] = att.gaps
        extra.update(
            launched_share=att.launched_s / att.device_s * 100
            if att.device_s else None,
            spanned_share=att.spanned_s / att.device_s * 100
            if att.device_s else None,
            unspanned_s=att.device_s - att.spanned_s,
            violations=att.violations,
            device_drift_us=att.device_drift_s * 1e6,
            host_offsets_us=[o / 1e3 for _, o in tracer.offsets])
    line["spans"] = {"readings": values, **extra}
    return line


def run(cell: str, seed: int, seconds: float, **kw) -> dict:
    """One traced run of ``cell`` through the harness with spans on:
    its result line, extended (:func:`extend`).  ``kw`` go to
    :func:`portbench.harness.run_cell`."""
    from . import harness
    if obs is not None:
        obs.enable()
    made = []

    def tracer(device):
        made.append(SpanTracer(device))
        return made[-1]

    plain = trace.Tracer
    trace.Tracer = tracer
    try:
        line = harness.run_cell(cell, seed, seconds, True,
                                t_start=kw.pop("t_start",
                                               time.perf_counter()), **kw)
    finally:
        trace.Tracer = plain
        if obs is not None:
            obs.disable()
    return extend(line, made[-1] if made else None)


def main(argv=None) -> int:
    import argparse
    t_start = time.perf_counter()
    ap = argparse.ArgumentParser(
        description="One traced run of a cell with the port's spans on.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    import torch

    from . import harness
    if not torch.cuda.is_available():
        print(f"{args.workload} needs a CUDA device", file=sys.stderr)
        return 2
    harness.set_environment()
    line = run(args.workload, args.seed, args.seconds, t_start=t_start)
    print(json.dumps(harness.json_safe(line), allow_nan=False), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
