"""One run of one cell: set-up, the measured window, the comparison with
the plain reference, the metrics, and the result line.

Everything is found by name from ``BENCHMARK.json`` at the root of the
checkout: the cell names its configuration (``configs/<config>.json``,
with its reference ``reference/<config>.py``) and its traffic mix
(``traffic/<mix>.json``); each metric the cell reports is read by
``metrics/<metric>.py``.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
#: The benchmark's own cache directories, inside the checkout at fixed
#: paths: the port's on-disk plan cache.  The port's nvcc libraries go to
#: ``build/repro_torch/`` in the checkout by themselves.
CACHE = ROOT / "portbench" / ".cache"
CACHE_ENV = {"REPRO_PLAN_CACHE_DIR": CACHE / "plans"}
#: Top-level modules that may not be loaded in a run's process.
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def set_environment() -> None:
    for key, path in CACHE_ENV.items():
        os.environ[key] = str(path)
    os.environ["USE_FLAX"] = "0"


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one of :data:`FORBIDDEN`,
    compared whole (``repro_torch`` is not ``repro``)."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def load_benchmark() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def with_held(bench: dict) -> dict:
    """``bench`` with the cells held out of it (``held.json``): their
    configurations, their workloads, and each in the metrics of the cell
    it reports ``like``."""
    held = json.loads((ROOT / "portbench" / "held.json").read_text())
    out = json.loads(json.dumps(bench))
    out["configs"] += held["configs"]
    for cell in held["workloads"]:
        like = cell["like"]
        out["workloads"].append({k: v for k, v in cell.items()
                                 if k != "like"})
        for m in out["end_to_end"] + out["per_layer"]:
            if like in m.get("workloads", ()):
                m["workloads"].append(cell["name"])
    return out


def metric_entries(bench: dict, cell: str, trace: bool) -> list:
    """The metrics a run of ``cell`` reports: the end-to-end ones with
    ``trace`` off, the per-layer ones with it on; an entry with a
    ``workloads`` list only in those cells."""
    entries = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in entries if cell in m.get("workloads", [cell])]


@dataclasses.dataclass
class Run:
    """What the metric readers read: the set-up and compile times, the
    window, the traced sub-window's summary (None untraced), the output
    points of one example and the least time the card needs for one (None
    on a card the yardstick does not know)."""
    setup_s: float
    plan_ms: float
    window: object
    trace: object
    points: int
    least_s: float | None


def rel_l2(out, ref, skip=None) -> float:
    """``||out - ref|| / ||ref||`` in float64 over the whole array, or
    over the elements where ``skip`` is false; infinite where ``out``
    holds a non-finite value anywhere or the shapes differ."""
    import torch
    if tuple(out.shape) != tuple(ref.shape):
        return math.inf
    out = out.double()
    if not bool(torch.isfinite(out).all()):
        return math.inf
    if skip is not None:
        out = out.masked_fill(skip, 0.0)
        ref = ref.masked_fill(skip, 0.0)
    den = float(torch.linalg.vector_norm(ref))
    num = float(torch.linalg.vector_norm(out - ref))
    return num / den if den > 0 else num


def compare(reference, judged: list) -> dict:
    """Run the reference in float64 on each judged example's inputs, one
    example at a time.  Returns the widest ``rel_l2`` over every output of
    every example, leaving out the elements the reference marks as
    undecided at the program's precision (``undecided``, where the
    reference has it), and beside it the widest over whole arrays, the
    undecided elements counted, and the examples judged."""
    import torch
    worst = whole = 0.0
    skipped = 0
    for inputs, outputs in judged:
        with torch.no_grad():
            x = {k: v.double() for k, v in inputs.items()}
            ref = reference.forward(x)
            skip = (reference.undecided(x)
                    if hasattr(reference, "undecided") else {})
        del x
        for name, want in ref.items():
            got, mask = outputs[name], skip.get(name)
            worst = max(worst, rel_l2(got, want, mask))
            whole = max(whole, rel_l2(got, want))
            skipped += int(mask.sum()) if mask is not None else 0
        del ref, skip
    return {"rel_l2": worst, "rel_l2_whole": whole,
            "undecided": skipped, "judged": len(judged)}


def json_safe(obj):
    """``obj`` with every non-finite float (an output that held NaN reads
    ``rel_l2`` infinite) as None, so that the line is strict JSON."""
    if isinstance(obj, float) and not math.isfinite(obj):
        return None
    if isinstance(obj, dict):
        return {k: json_safe(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [json_safe(v) for v in obj]
    return obj


def smi_line() -> str | None:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else None


def run_cell(cell_name: str, seed: int, seconds: float, trace: bool, *,
             t_start: float, device=None, dims=None, mix=None,
             control: bool = False, bench: dict | None = None) -> dict:
    """One run of ``cell_name``; returns the result line as a dict.
    ``device`` defaults to the first card.  For the tests and the
    readings, never in a benchmark run: ``dims`` overrides the mix's grid,
    ``mix`` its other entries, ``control=True`` runs the configuration's
    lower-precision path, and ``bench`` stands in for ``BENCHMARK.json``
    (with the held cells of ``held.json``, say)."""
    import torch
    from repro_torch.core.programs import ALL_PROGRAMS

    from . import generator, loops, metrics, reference, trace as tracing
    from .metrics import _yardstick
    phases = [("imports", time.perf_counter())]

    bench = bench or load_benchmark()
    cell = next(c for c in bench["workloads"] if c["name"] == cell_name)
    entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    config = json.loads((ROOT / entry["file"]).read_text())
    mix = {**generator.load_mix(cell["traffic"]), **(mix or {})}
    dims = dict(dims or mix["dims"])
    device = torch.device(device if device is not None else "cuda:0")
    dtype = getattr(torch, config["control"]["dtype"] if control
                    else config["dtype"])
    ref = reference.load(config["name"])

    program = ALL_PROGRAMS[config["program"]]()
    if device.type == "cuda":
        torch.cuda.init()
        torch.empty(0, device=device)
    phases.append(("device", time.perf_counter()))
    fields = generator.make_fields(config, dims, seed, mix.get("clients", 1),
                                   mix["fields"], device)
    phases.append(("inputs", time.perf_counter()))
    loop = loops.load(mix["loop"])(program, config, mix, fields, device,
                                   dtype)
    phases.append(("compile", time.perf_counter()))
    loop.warm()
    phases.append(("warm-up", time.perf_counter()))
    tracer = None
    if trace:
        tracer = tracing.Tracer(device)
        tracer.warm()
        phases.append(("profiler", time.perf_counter()))
    setup_s = time.perf_counter() - t_start
    marks = [t_start] + [t for _, t in phases]
    print("set-up: " + ", ".join(
        f"{name} {b - a:.3f} s" for (name, _), a, b in
        zip(phases, marks, marks[1:])), file=sys.stderr, flush=True)

    window = loop.window(seconds, tracer)
    cuda = device.type == "cuda"
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    judged = loop.judged()
    loop.close()
    summary = None
    if tracer is not None and tracer.prof is not None:
        summary = tracer.summary()
        summary.examples = window.trace_examples

    cmp = compare(ref, judged)
    del judged, fields
    worst, limit = cmp["rel_l2"], config["limits"]["rel_l2"]
    correct = window.failed == 0 and cmp["judged"] > 0 and worst <= limit

    name = torch.cuda.get_device_name(device) if cuda else "cpu"
    run = Run(setup_s=setup_s, plan_ms=loop.plan_ms,
              window=window, trace=summary,
              points=_yardstick.points(config, dims),
              least_s=_yardstick.least_seconds(
                  config, dims, _yardstick.flops_per_point(ref.BODIES), name))
    values = {}
    for m in metric_entries(bench, cell_name, trace):
        v = metrics.load(m["name"]).read(run)
        if v is not None:
            values[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu", "kind": name,
           "count": cell["chips"], "memory_peak_bytes": peak}
    line = {"correct": correct, "attempted": window.attempted,
            "failed": window.failed, "metrics": values, "device": dev}
    if summary is not None:
        dev["busy_s"] = summary.busy_s
        dev["window_s"] = summary.window_s
        if cuda:
            dev["power_limit"] = smi_line()
        ops = sorted(summary.by_name.items(), key=lambda kv: -kv[1])
        line["breakdown"] = {
            "device_ops": [[k, v] for k, v in ops[:tracing.TOP]],
            "idle_gaps": summary.gaps}
    line["compared"] = {k: cmp[k] for k in ("rel_l2_whole", "undecided",
                                            "judged")}
    line["checks"] = {"rel_l2": {"value": worst, "limit": limit},
                      "failed": {"value": window.failed, "limit": 0}}
    return json_safe(line)


def main(argv=None, t_start: float | None = None) -> int:
    import argparse
    t_start = time.perf_counter() if t_start is None else t_start
    ap = argparse.ArgumentParser(
        description="Run one cell of the port's benchmark once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch
    bench = load_benchmark()
    cells = {c["name"]: c for c in bench["workloads"]}
    if args.workload not in cells:
        print(f"unknown workload {args.workload!r}; cells: "
              f"{sorted(cells)}", file=sys.stderr)
        return 2
    need = cells[args.workload]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{args.workload} needs {need} CUDA device(s); found {have}",
              file=sys.stderr)
        return 2
    set_environment()
    line = run_cell(args.workload, args.seed, args.seconds,
                    bool(args.trace), t_start=t_start)
    bad = forbidden_modules()
    if bad:
        print(f"modules of JAX or the JAX package were loaded: {bad}",
              file=sys.stderr)
        return 3
    print(json.dumps(line, allow_nan=False), flush=True)
    for key, c in line["checks"].items():
        print(f"check {key} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr, flush=True)
    return 0
