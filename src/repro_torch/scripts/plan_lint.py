"""Lint KernelPlans with the static analyzers (plancheck and vecscan);
the port of the reference's ``scripts/plan_lint.py``.

Targets, freely mixed, any number of them::

    PYTHONPATH=src python -m repro_torch.scripts.plan_lint heat3d cosmo
    PYTHONPATH=src python -m repro_torch.scripts.plan_lint tests/goldens/plans
    PYTHONPATH=src python -m repro_torch.scripts.plan_lint DIR/<key>.json

* a **program name** from :mod:`repro_torch.core.programs` is planned
  through the analysis pipeline and the plan is linted;
* a **file** is loaded as a serialized plan: the bare golden form
  (``KernelPlan.to_dict``, the reference's or the port's) and both
  plan-cache entry forms (the reference's ``{"jax", "repro", "plan"}``
  header and the port's ``{"torch", "cuda", "repro_torch", "plan"}``)
  are accepted, the reference's kernel bodies re-linked onto the port's;
* a **directory** (a plan cache or a golden corpus) lints every
  ``*.json`` inside it;
* no target at all lints the golden corpus of the repository
  (``tests/goldens/plans``) and every ``ALL_PROGRAMS`` entry.

A file that fails to load or validate is reported as ``PC000``.  With
``--sizes Nj=64,Ni=512`` the budget check (PC003) runs against
``--vmem-budget`` / ``REPRO_VMEM_BUDGET_BYTES``.  ``--vec`` also runs
the vectorization analyzer and merges its ``PV`` diagnostics in.
``--format json`` prints one JSON object per plan (target, counts,
diagnostics and, under ``--vec``, the vector-efficiency summary).  The
exit status is non-zero iff a target carries an error-severity finding
(``--strict``: a warning too), in both formats.

``--apply-layout auto|force`` runs every plan through LayoutApply
before linting.  ``--update-vec-baseline PATH`` writes the per-plan
error counts of the golden corpus under ``--vec`` (and the chosen
``--apply-layout``) to ``PATH`` instead of linting; it writes nowhere
else.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import sys

from ..core.plan import KernelPlan, from_reference_dict
from ..core.plancheck import Diagnostic, check_plan, has_errors
from .warm_cache import plan_program

#: The repository's golden corpus (read, never written, by this tool).
GOLDEN_DIR = pathlib.Path(__file__).resolve().parents[3] / "tests" \
    / "goldens" / "plans"


def load_plan_file(path: pathlib.Path) -> KernelPlan:
    """Deserialize one plan file, unwrapping a plan-cache header and
    re-linking the reference's kernel bodies onto the port's."""
    payload = json.loads(path.read_text())
    if "plan" in payload and "schema" not in payload:
        payload = payload["plan"]
    return from_reference_dict(payload, validate=False)


def _resolve_plan(target: str):
    """One target to ``(kplan, load-failure Diagnostic or None)``."""
    path = pathlib.Path(target)
    if path.is_dir():
        raise ValueError("directories are expanded by the caller")
    if path.exists():
        try:
            return load_plan_file(path), None
        except Exception as e:  # every load failure is a finding
            return None, Diagnostic(
                "PC000", "error", path.stem, "",
                f"plan failed to load: {type(e).__name__}: {e}")
    from ..core.programs import ALL_PROGRAMS
    if target not in ALL_PROGRAMS:
        return None, Diagnostic(
            "PC000", "error", target, "",
            f"no such file, directory, or program "
            f"(known programs: {', '.join(sorted(ALL_PROGRAMS))})")
    return plan_program(ALL_PROGRAMS[target])[1], None


def lint_target(target: str, sizes, budget=None, *, vec: bool = False,
                apply_mode: str = "off"):
    """One target to ``(label, diagnostics, vec summary or None)``."""
    kplan, failure = _resolve_plan(target)
    if failure is not None:
        return target, [failure], None
    if apply_mode != "off":
        from ..core.layoutapply import apply_layout
        try:
            kplan = apply_layout(kplan, mode=apply_mode, sizes=sizes).plan
        except Exception as e:  # a failed transformation is a finding
            return target, [Diagnostic(
                "PC000", "error", target, "",
                f"layout apply ({apply_mode}) failed: "
                f"{type(e).__name__}: {e}")], None
    diags = check_plan(kplan, sizes=sizes, budget=budget)
    summary = None
    if vec and not has_errors(diags):
        from ..core.vecscan import scan_plan
        rep = scan_plan(kplan, sizes=sizes)
        diags = list(diags) + list(rep.diagnostics)
        summary = rep.summary()
    return target, diags, summary


def update_vec_baseline(path: pathlib.Path, sizes, budget=None, *,
                        apply_mode: str = "off") -> int:
    """Write the golden corpus's per-plan error counts under ``--vec``
    (and ``apply_mode``) to ``path``."""
    errors = {}
    for plan in sorted(GOLDEN_DIR.glob("*.json")):
        _, diags, _ = lint_target(str(plan), sizes, budget, vec=True,
                                  apply_mode=apply_mode)
        errors[plan.name] = sum(d.severity == "error" for d in diags)
    payload = {
        "comment": "error-severity counts per golden plan from "
                   "python -m repro_torch.scripts.plan_lint --vec "
                   f"--apply-layout {apply_mode} --format json",
        "errors": errors,
    }
    path.write_text(json.dumps(payload, indent=1, sort_keys=True) + "\n")
    print(f"plan_lint: wrote {path} ({len(errors)} plan(s), "
          f"{sum(errors.values())} error(s), apply_layout={apply_mode})")
    return 0


def parse_sizes(spec):
    """``"Nj=64,Ni=512"`` -> ``{"Nj": 64, "Ni": 512}`` (None stays None)."""
    if not spec:
        return None
    sizes = {}
    for part in spec.split(","):
        sym, _, val = part.partition("=")
        if not val:
            raise SystemExit(f"--sizes: expected SYM=INT, got {part!r}")
        sizes[sym.strip()] = int(val)
    return sizes


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Lint KernelPlans (programs by name, serialized plan "
                    "files, or whole plan-cache/golden directories) with "
                    "the port's plancheck and, under --vec, vecscan.")
    ap.add_argument("targets", nargs="*",
                    help="program names, plan files, or directories "
                         "(default: the golden corpus + ALL_PROGRAMS)")
    ap.add_argument("--sizes", default=None, metavar="Nj=64,Ni=512",
                    help="concrete dim sizes enabling the budget check "
                         "(PC003) and the concrete vec model")
    ap.add_argument("--vmem-budget", type=int, default=None, metavar="BYTES",
                    help="budget for PC003 (default: "
                         "REPRO_VMEM_BUDGET_BYTES or ~16 MiB)")
    ap.add_argument("--vec", action="store_true",
                    help="also run the vectorization analyzer (PV "
                         "diagnostics)")
    ap.add_argument("--apply-layout", choices=("off", "auto", "force"),
                    default="off", metavar="MODE",
                    help="run plans through LayoutApply before linting: "
                         "off (default), auto, or force")
    ap.add_argument("--update-vec-baseline", default=None, metavar="PATH",
                    help="write the golden corpus's vec-lint error counts "
                         "to PATH (honors --apply-layout and --sizes) "
                         "instead of linting targets")
    ap.add_argument("--format", choices=("text", "json"), default="text",
                    help="human-readable text (default) or one JSON "
                         "object per plan")
    ap.add_argument("--strict", action="store_true",
                    help="exit non-zero on warnings too")
    ap.add_argument("-q", "--quiet", action="store_true",
                    help="print findings only, no per-target OK lines "
                         "(text format)")
    args = ap.parse_args(argv)
    sizes = parse_sizes(args.sizes)

    if args.update_vec_baseline:
        return update_vec_baseline(pathlib.Path(args.update_vec_baseline),
                                   sizes, args.vmem_budget,
                                   apply_mode=args.apply_layout)

    targets: list[str] = []
    for t in args.targets or ([str(GOLDEN_DIR)] if GOLDEN_DIR.is_dir()
                              else []):
        path = pathlib.Path(t)
        if path.is_dir():
            targets.extend(sorted(str(p) for p in path.glob("*.json")))
        else:
            targets.append(t)
    if not args.targets:
        from ..core.programs import ALL_PROGRAMS
        targets.extend(sorted(ALL_PROGRAMS))

    n_err = n_warn = 0
    for target in targets:
        label, diags, summary = lint_target(target, sizes,
                                            args.vmem_budget, vec=args.vec,
                                            apply_mode=args.apply_layout)
        errs = [d for d in diags if d.severity == "error"]
        warns = [d for d in diags if d.severity != "error"]
        n_err += len(errs)
        n_warn += len(warns)
        if args.format == "json":
            record = {"target": label, "errors": len(errs),
                      "warnings": len(warns),
                      "diagnostics": [dataclasses.asdict(d) for d in diags]}
            if summary is not None:
                record["vec"] = summary
            print(json.dumps(record, sort_keys=True))
            continue
        if not diags:
            if not args.quiet:
                print(f"  {label}: OK")
            continue
        print(f"  {label}: {len(errs)} error(s), {len(warns)} warning(s)")
        for d in diags:
            print(f"    {d}")
    if args.format != "json":
        print(f"plan_lint: {len(targets)} target(s), {n_err} error(s), "
              f"{n_warn} warning(s)")
    if n_err or (args.strict and n_warn):
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
