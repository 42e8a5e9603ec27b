"""HFAV engine entry point: program -> inference -> dataflow -> fusion ->
storage analysis -> planner -> a registered plan interpreter.

The port's counterpart of :func:`compile_program` in
``repro.core.engine``, slimmed to the plan-interpreter path.
:func:`compile_program` runs the shared analysis pipeline, lowers the
schedule to a validated :class:`~repro_torch.core.plan.KernelPlan`
(:func:`repro_torch.core.planner.plan_pallas`) and hands it to the
named interpreter of the registry (:mod:`repro_torch.core.interpreters`)
through the shared host half, returning a
:class:`~repro_torch.core.planner.PallasGenerated`.  Built-ins:
``"cuda"`` (the default: the hand-written CUDA stencil kernel) and
``"interp_torch"`` (its plain PyTorch version).

``"auto"`` and ``"jax"`` fall back to the JAX package's fused-source
emitter, which the port does not have yet: they raise
``NotImplementedError``.  The layout pass is not ported either, so
plans always execute untransformed.

Compiled results are memoized in memory, keyed on (program signature,
backend, dtype, device, build options).
"""
from __future__ import annotations

import warnings
from typing import Optional

import torch

from .dataflow import build_dataflow
from .fusion import fuse_inest_dag
from .infer import infer
from .interpreters import (execute_plan, get_interpreter,
                           registered_interpreters, resolve_device)
from .plan import fn_key as _fn_key
from .plancheck import (PlanCheckError, PlanCheckWarning, check_plan,
                        has_errors, resolve_check_mode)
from .planner import PallasGenerated, plan_pallas
from .reuse import analyze_storage
from .rules import Program

#: Backends of the JAX package that need its fused-source emitter.
EMITTER_BACKENDS = ("auto", "jax")

_CACHE: dict = {}


def program_signature(program: Program):
    """A hashable identity for a program: two structurally identical
    programs (same rules/axioms/goals/loop order, same kernel callables
    — rebuilt lambdas compare by code object, see
    :func:`repro_torch.core.plan.fn_key`) share compiled artifacts."""

    def params(ps):
        return tuple((p.name, str(p.pattern)) for p in ps)

    def exts(e):
        return tuple(sorted((d, x.size, x.lo, x.hi) for d, x in e.items()))

    rules = tuple(
        (r.name, params(r.inputs), params(r.outputs), r.kind, r.init,
         _fn_key(r.fn))
        for r in program.rules
    )
    axioms = tuple((str(a.term), exts(a.extents)) for a in program.axioms)
    goals = tuple((str(g.term), g.store_as, exts(g.extents))
                  for g in program.goals)
    return (program.name, rules, axioms, goals,
            tuple(program.loop_order), tuple(program.aliases))


def clear_compile_cache() -> None:
    """Drop every memoized compilation."""
    _CACHE.clear()


def compile_cache_size() -> int:
    """Number of live entries in the compile cache."""
    return len(_CACHE)


def _run_plancheck(kplan, mode: str) -> None:
    """Gate a plan on the static analyzer per the resolved
    ``check_plans`` mode: ``"error"`` raises
    :class:`~repro_torch.core.plancheck.PlanCheckError` on
    error-severity findings, ``"warn"`` turns every finding into a
    :class:`~repro_torch.core.plancheck.PlanCheckWarning`, ``"off"``
    skips the analyses."""
    if mode == "off":
        return
    diags = check_plan(kplan, validate=False)
    if not diags:
        return
    if mode == "error" and has_errors(diags):
        raise PlanCheckError(
            f"plan {kplan.program!r} failed static analysis:\n" +
            "\n".join(f"  {d}" for d in diags), diags)
    for d in diags:
        warnings.warn(str(d), PlanCheckWarning, stacklevel=3)


def compile_program(
    program: Program,
    backend: str = "cuda",
    *,
    dtype=torch.float32,
    device=None,
    use_cache: bool = True,
    check_plans: Optional[str] = None,
    **options,
) -> PallasGenerated:
    """Compile ``program`` through the HFAV pipeline onto a registered
    plan interpreter.

    ``backend`` names the interpreter (``"cuda"`` by default, or
    ``"interp_torch"``).  ``device`` is where the compiled ``fn`` runs:
    the current CUDA device when omitted (and an error without CUDA);
    pass ``device="cpu"`` to run on the CPU.  ``options`` are the
    interpreter's build options (the ``"cuda"`` kernel takes
    ``chunk``, its row-chunk length, and ``plane_chunk``, the
    plane-chunk length of a call with plane windows).  Results are
    memoized; pass ``use_cache=False`` to force a rebuild.

    ``check_plans`` gates the plan on the static analyzer
    (:mod:`repro_torch.core.plancheck`): ``"warn"`` (the default,
    overridable via ``REPRO_CHECK_PLANS``), ``"error"`` or ``"off"``.

    Raises :class:`~repro_torch.core.plan.PallasUnsupported` for
    programs outside the planner's shape and the typed
    :class:`~repro_torch.core.interpreters.PlanUnsupported` for plans or
    dtypes outside the interpreter's declared capabilities."""
    if backend in EMITTER_BACKENDS:
        raise NotImplementedError(
            f"backend {backend!r} needs the fused-source emitter "
            f"(repro.core.codegen_jax), which the port does not have "
            f"yet: see ROADMAP.md, Queue 1, 'core/codegen_jax.py'")
    try:
        get_interpreter(backend)
    except ValueError:
        raise ValueError(
            f"unknown backend {backend!r}; expected a registered "
            f"interpreter: {registered_interpreters()}") from None
    dev = resolve_device(device)
    check = resolve_check_mode(check_plans)
    key = (program_signature(program), backend, str(dtype), str(dev),
           tuple(sorted(options.items())))
    if use_cache and key in _CACHE:
        return _CACHE[key]
    idag = infer(program)
    plan = analyze_storage(fuse_inest_dag(build_dataflow(idag)))
    kplan = plan_pallas(plan, idag)
    _run_plancheck(kplan, check)
    fn = execute_plan(kplan, interpreter=backend, dtype=dtype, device=dev,
                      **options)
    gen = PallasGenerated(kplan, fn, plan, interpreter=backend, device=dev)
    if use_cache:
        _CACHE[key] = gen
    return gen
