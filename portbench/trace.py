"""The traced sub-window: ``torch.profiler`` over the middle of a run's
window, device activity only (no host events, so the trace costs the
host nothing per call), reduced in memory to the few numbers the
per-layer readers take.  No trace file is written.
"""
from __future__ import annotations

import dataclasses
import time
import warnings

import torch

#: The name of K1's kernel on the device (``kernels/stencil2d``'s
#: emitted sources, single and batched alike).
K1_NAME = "hfav_kernel"
NAME_CHARS = 120
TOP = 10


@dataclasses.dataclass
class TraceSummary:
    """What the traced sub-window saw: its length on the host's clock,
    the union of device activity in it, device time by operation name,
    K1's share of it, the longest idle gaps, and the examples (steps or
    requests) the harness saw complete in it."""
    window_s: float
    busy_s: float
    by_name: dict
    k1_s: float
    other_s: float
    gaps: list
    examples: int = 0


def _short(name: str) -> str:
    name = name[5:] if name.startswith("void ") else name
    return name[:NAME_CHARS]


def _device_events(prof):
    out = []
    for e in prof.profiler.kineto_results.events():
        if not str(e.device_type()).endswith("CUDA"):
            continue
        start = e.start_ns()
        out.append((start, start + e.duration_ns(), e.name()))
    return out


def summarize(events, window_s: float) -> TraceSummary:
    """Reduce ``(start_ns, end_ns, name)`` device intervals."""
    by_name: dict = {}
    k1 = other = 0.0
    for s, e, name in events:
        dur = (e - s) * 1e-9
        key = _short(name)
        by_name[key] = by_name.get(key, 0.0) + dur
        if name.startswith(K1_NAME):
            k1 += dur
        else:
            other += dur
    busy = 0
    gaps = []
    cur_s = cur_e = None
    cur_last = None
    for s, e, name in sorted(events):
        if cur_e is None:
            cur_s, cur_e, cur_last = s, e, name
        elif s > cur_e:
            busy += cur_e - cur_s
            gaps.append(((s - cur_e) * 1e-9,
                         f"{_short(cur_last)} -> {_short(name)}"))
            cur_s, cur_e, cur_last = s, e, name
        elif e >= cur_e:
            cur_e, cur_last = e, name
    if cur_e is not None:
        busy += cur_e - cur_s
    gaps.sort(reverse=True)
    return TraceSummary(window_s=window_s, busy_s=busy * 1e-9,
                        by_name=by_name, k1_s=k1, other_s=other,
                        gaps=[[label, secs] for secs, label in gaps[:TOP]])


class Tracer:
    """Profiles the device from :meth:`start` to :meth:`stop`, each
    preceded by a synchronisation, so that the device work in between is
    the work enqueued in between."""

    def __init__(self, device: torch.device):
        self.device = device
        self.prof = None
        self.t0 = self.t1 = None

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _profile(self):
        from torch.profiler import ProfilerActivity, profile
        act = (ProfilerActivity.CUDA if self.device.type == "cuda"
               else ProfilerActivity.CPU)
        warnings.filterwarnings("ignore", message=".*Profiler clears events")
        return profile(activities=[act])

    def warm(self) -> None:
        """Start and stop the profiler once around a small operation: its
        first start initialises the device tracing, which takes seconds
        and belongs in set-up."""
        prof = self._profile()
        prof.start()
        torch.ones(1024, device=self.device).sum()
        self._sync()
        prof.stop()

    def start(self) -> None:
        self._sync()
        self.prof = self._profile()
        self.prof.start()
        self.t0 = time.perf_counter()

    def stop(self) -> None:
        self._sync()
        self.t1 = time.perf_counter()
        self.prof.stop()

    def summary(self) -> TraceSummary:
        events = _device_events(self.prof) if self.device.type == "cuda" \
            else []
        return summarize(events, self.t1 - self.t0)
