"""Pre-plan every program of :mod:`repro_torch.core.programs` into the
port's on-disk plan cache (and, with ``--goldens DIR``, write the
golden-plan corpus into ``DIR``); the port of the reference's
``scripts/warm_cache.py``.

Run from the repository root::

    PYTHONPATH=src python -m repro_torch.scripts.warm_cache --cache-dir DIR
    PYTHONPATH=src python -m repro_torch.scripts.warm_cache --goldens DIR \
        [--port-goldens DIR]

A warmed cache directory lets a later process compile these programs
without the analysis pipeline: ``compile_program(prog,
plan_cache_dir=DIR)`` loads the serialized
:class:`~repro_torch.core.plan.KernelPlan` (keyed on the program, the
plan schema, the torch and CUDA versions and the port's version:
:mod:`repro_torch.core.plancache`), re-validates it and builds the
interpreter directly.  ``--goldens`` writes each plan of the
reference's programs in its ``to_dict`` form, one ``<program>.json``
per program, as the reference's corpus is written (the kernel bodies'
module is the port's);
``--port-goldens`` writes the port's own programs (``PORT_ONLY``, which
the reference's corpus does not hold) the same way.  Every plan is gated
on the static analyzer first: a plan with an error-severity finding is
persisted nowhere, and the exit status is 1.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys

from ..core.dataflow import build_dataflow
from ..core.fusion import fuse_inest_dag
from ..core.infer import infer
from ..core.plancache import PlanCache, program_plan_key
from ..core.plancheck import check_plan, has_errors
from ..core.planner import plan_pallas
from ..core.programs import ALL_PROGRAMS, PORT_ONLY
from ..core.reuse import analyze_storage


def plan_program(build):
    """The analysis pipeline (no execution) for one builder:
    ``(program, kplan)``."""
    program = build()
    idag = infer(program)
    storage = analyze_storage(fuse_inest_dag(build_dataflow(idag)))
    return program, plan_pallas(storage, idag)


def golden_text(kplan) -> str:
    """A plan as the golden corpus holds it."""
    return json.dumps(kplan.to_dict(), indent=1, sort_keys=True) + "\n"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Pre-plan every repro_torch.core.programs entry into "
                    "an on-disk plan cache and/or a golden-plan corpus.")
    ap.add_argument("--cache-dir", default=None,
                    help="plan-cache directory to warm (created if "
                         "missing)")
    ap.add_argument("--goldens", default=None, metavar="DIR",
                    help="directory to write the golden corpus of the "
                         "reference's programs into (<program>.json "
                         "each; created if missing)")
    ap.add_argument("--port-goldens", default=None, metavar="DIR",
                    help="directory to write the port's own programs' "
                         "goldens into (created if missing)")
    args = ap.parse_args(argv)
    if args.cache_dir is None and args.goldens is None \
            and args.port_goldens is None:
        ap.error("nothing to do: pass --cache-dir and/or --goldens DIR")

    cache = PlanCache(args.cache_dir) if args.cache_dir else None
    dirs = {False: args.goldens, True: args.port_goldens}
    dirs = {k: pathlib.Path(v) for k, v in dirs.items() if v}
    for d in dirs.values():
        d.mkdir(parents=True, exist_ok=True)
    refused = 0
    for name, build in sorted(ALL_PROGRAMS.items()):
        program, kplan = plan_program(build)
        what = []
        # a poisoned cache entry or golden reaches every later process
        diags = check_plan(kplan)
        if has_errors(diags):
            refused += 1
            print(f"  {name:24s} REFUSED: "
                  f"{sum(d.severity == 'error' for d in diags)} "
                  f"error-severity finding(s)")
            for d in diags:
                print(f"      {d}")
            continue
        for d in diags:
            print(f"      {d}")
        if cache is not None:
            stored = cache.put(program_plan_key(program), kplan)
            what.append("cached" if stored else "NOT SERIALIZABLE")
        golden_dir = dirs.get(name in PORT_ONLY)
        if golden_dir is not None:
            (golden_dir / f"{name}.json").write_text(golden_text(kplan))
            what.append("golden")
        print(f"  {name:24s} {len(kplan.calls)} call(s)  [{', '.join(what)}]")
    if cache is not None:
        print(f"warmed {args.cache_dir}: {len(cache)} entr(y/ies)")
    for d in dirs.values():
        print(f"wrote goldens to {d}")
    if refused:
        print(f"refused to persist {refused} plan(s) with error-severity "
              f"findings (see python -m repro_torch.scripts.plan_lint)")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
