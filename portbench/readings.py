"""The readings a cell's limit is set from, in one process: the sound
program on many seeds, then the control (the configuration's
lower-precision path, ``control`` in its file) on a few, each a short
window of the cell's own traffic at its own size through the same code
as a benchmark run.

    python3 -m portbench.readings --workload cosmo-step \\
        --seeds 101,102,...,112 --control-seeds 201,202,203 --seconds 2 \\
        [--out readings_cosmo-step.json]

The lower reading is the largest ``rel_l2`` of the sound runs, the upper
one the smallest of the control's; the limit in the configuration's file
lies between them.  The benchmark's own runs never run the control.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

_ROOT = pathlib.Path(__file__).resolve().parents[1]


def read(workload: str, seeds: list, control_seeds: list, seconds: float,
         device=None, dims=None, bench=None) -> dict:
    from .harness import run_cell
    out = {"workload": workload, "seconds": seconds, "sound": [],
           "control": []}
    for kind, seq, control in (("sound", seeds, False),
                               ("control", control_seeds, True)):
        for seed in seq:
            line = run_cell(workload, seed, seconds, False,
                            t_start=time.perf_counter(), device=device,
                            dims=dims, control=control, bench=bench)
            row = {"seed": seed, "correct": line["correct"],
                   "rel_l2": line["checks"]["rel_l2"]["value"],
                   **line["compared"],
                   "attempted": line["attempted"],
                   "failed": line["failed"]}
            out[kind].append(row)
            print(f"[{workload} {kind}] {row}", flush=True)
    if out["sound"]:
        out["lower"] = max(r["rel_l2"] for r in out["sound"])
    if out["control"]:
        out["upper"] = min(r["rel_l2"] for r in out["control"])
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    from .harness import set_environment
    set_environment()
    result = read(args.workload,
                  [int(s) for s in args.seeds.split(",") if s],
                  [int(s) for s in args.control_seeds.split(",") if s],
                  args.seconds)
    print(json.dumps(result), flush=True)
    if args.out:
        pathlib.Path(args.out).write_text(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    for p in (str(_ROOT / "src"), str(_ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)
    sys.exit(main())
