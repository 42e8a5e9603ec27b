"""Fault-tolerance scaffolding: heartbeats, straggler detection (the port
of ``repro.ft.watchdog``, pure Python).

* :class:`Heartbeat` -- an atomically updated per-host file with step
  and wall time; a supervisor (or :func:`check_heartbeats`) declares a
  host dead after ``timeout_s`` and restarts the job from the last
  committed checkpoint (:mod:`repro_torch.ckpt.checkpoint` commits
  atomically);
* :class:`StragglerDetector` -- robust per-step timing statistics
  (median and MAD); hosts whose step time exceeds ``median + k * MAD``
  for ``patience`` consecutive polls are flagged.
"""
from __future__ import annotations

import json
import os
import statistics
import time
from dataclasses import dataclass, field


class Heartbeat:
    def __init__(self, run_dir: str, host_id: int):
        self.path = os.path.join(run_dir, f"heartbeat_{host_id}.json")
        os.makedirs(run_dir, exist_ok=True)

    def beat(self, step: int, extra: dict | None = None) -> None:
        rec = {"step": step, "time": time.time()}
        if extra:
            rec.update(extra)
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(rec, f)
        os.replace(tmp, self.path)  # atomic


def check_heartbeats(run_dir: str, timeout_s: float,
                     now: float | None = None) -> list[int]:
    """Host ids whose heartbeat is stale or torn (the supervisor's
    poll)."""
    now = now if now is not None else time.time()
    dead = []
    for name in os.listdir(run_dir):
        if not name.startswith("heartbeat_"):
            continue
        host = int(name.split("_")[1].split(".")[0])
        try:
            with open(os.path.join(run_dir, name)) as f:
                rec = json.load(f)
        except (json.JSONDecodeError, OSError):
            dead.append(host)  # a torn write is suspect
            continue
        if now - rec["time"] > timeout_s:
            dead.append(host)
    return sorted(dead)


@dataclass
class StragglerDetector:
    k: float = 4.0  # MAD multiplier
    patience: int = 3
    window: int = 50
    _times: dict[int, list[float]] = field(default_factory=dict)
    _strikes: dict[int, int] = field(default_factory=dict)

    def record(self, host_id: int, step_time: float) -> None:
        ts = self._times.setdefault(host_id, [])
        ts.append(step_time)
        if len(ts) > self.window:
            ts.pop(0)

    def stragglers(self) -> list[int]:
        """Hosts consistently slower than median + k * MAD of the
        fleet (needs at least three hosts)."""
        latest = {h: ts[-1] for h, ts in self._times.items() if ts}
        if len(latest) < 3:
            return []
        med = statistics.median(latest.values())
        mad = statistics.median(abs(t - med) for t in latest.values()) or 1e-9
        out = []
        for h, t in latest.items():
            self._strikes[h] = (self._strikes.get(h, 0) + 1
                                if t > med + self.k * mad else 0)
            if self._strikes[h] >= self.patience:
                out.append(h)
        return sorted(out)
