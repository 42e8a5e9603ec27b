"""Runs of one cell in sets, each run its own process, and the spread of
every metric: the tool that sets the bounds in ``BENCHMARK.json``.

    python3 -m portbench.spread --workload cosmo-step --seeds 11,12,13,14,15,16 \\
        --sets 2 --seconds 20 [--warm-seed 7] [--trace-seeds 21,22,23] \\
        [--out spread_cosmo-step.jsonl]

A ``--warm-seed`` run comes first and is kept apart (it builds the
kernels in a fresh checkout).  Every set runs the same seeds, in order.
A spread is the distance between the first and third quartiles
(``statistics.quantiles(values, n=4)``) as a share of the median; the
summary gives each set's and the wider of them.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]


def one(workload: str, seed: int, seconds: float, trace: int) -> dict:
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", workload,
         "--seed", str(seed), "--seconds", str(seconds), "--trace",
         str(trace)], cwd=ROOT, capture_output=True, text=True)
    wall = time.perf_counter() - t0
    lines = proc.stdout.strip().splitlines()
    try:
        result = json.loads(lines[-1]) if lines else None
    except json.JSONDecodeError:
        result = None
    err = [ln for ln in proc.stderr.splitlines() if "USDT" not in ln]
    return {"seed": seed, "trace": trace, "rc": proc.returncode,
            "wall_s": wall, "result": result, "stderr_tail": err[-6:]}


def spread(values: list) -> dict:
    med = statistics.median(values)
    q1, _, q3 = statistics.quantiles(values, n=4)
    return {"median": med, "q1": q1, "q3": q3,
            "spread": (q3 - q1) / med if med else float("nan"), "n": len(values)}


def summarize(runs: list) -> dict:
    out = {}
    for r in runs:
        if not r["result"]:
            continue
        for name, m in r["result"]["metrics"].items():
            out.setdefault(name, []).append(m["value"])
    return {name: spread(v) for name, v in out.items() if len(v) >= 2}


def show(r: dict) -> str:
    res = r["result"] or {}
    vals = {k: round(v["value"], 6) for k, v in res.get("metrics", {}).items()}
    checks = {k: v["value"] for k, v in res.get("checks", {}).items()}
    return (f"seed={r['seed']} trace={r['trace']} rc={r['rc']} "
            f"wall={r['wall_s']:.1f}s correct={res.get('correct')} "
            f"{vals} checks={checks}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--sets", type=int, default=2)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--warm-seed", type=int)
    ap.add_argument("--trace-seeds", default="")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    tseeds = [int(s) for s in args.trace_seeds.split(",") if s]
    out = open(args.out, "a") if args.out else None

    def record(kind: str, r: dict) -> None:
        print(f"[{args.workload} {kind}] {show(r)}", flush=True)
        if r["rc"] != 0 or not r["result"]:
            print("\n".join(r["stderr_tail"]), flush=True)
        if out:
            out.write(json.dumps({"workload": args.workload, "kind": kind,
                                  **r}) + "\n")
            out.flush()

    if args.warm_seed is not None:
        record("warm", one(args.workload, args.warm_seed, args.seconds, 0))
    sets = []
    for k in range(args.sets):
        runs = []
        for seed in seeds:
            r = one(args.workload, seed, args.seconds, 0)
            record(f"set{k + 1}", r)
            runs.append(r)
        sets.append(runs)
    for seed in tseeds:
        record("trace", one(args.workload, seed, args.seconds, 1))
    summary = {"workload": args.workload, "seconds": args.seconds,
               "sets": [summarize(runs) for runs in sets]}
    if sets:
        widest = {}
        for s in summary["sets"]:
            for name, st in s.items():
                widest[name] = max(widest.get(name, 0.0), st["spread"])
        summary["widest_spread"] = widest
    print(json.dumps(summary), flush=True)
    if out:
        out.write(json.dumps({"workload": args.workload, "kind": "summary",
                              **summary}) + "\n")
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
