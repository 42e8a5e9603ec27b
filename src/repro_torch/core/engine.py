"""HFAV engine entry point: program -> inference -> dataflow -> fusion ->
storage analysis -> backend dispatch.

The port's counterpart of ``repro.core.engine``.
:func:`compile_program` runs the shared analysis pipeline once and then
dispatches to a backend:

* ``backend="torch"`` — emit fused, vectorized PyTorch source
  (:mod:`repro_torch.core.codegen_torch`), returning
  :class:`~repro_torch.core.codegen_torch.Generated`;
* ``backend="<interpreter>"`` — any name in the plan-interpreter
  registry (:mod:`repro_torch.core.interpreters`): lower the schedule
  to a validated :class:`~repro_torch.core.plan.KernelPlan`
  (:func:`repro_torch.core.planner.plan_pallas`) and hand it to that
  interpreter through the shared host half, returning a
  :class:`~repro_torch.core.planner.PallasGenerated`; raises
  :class:`~repro_torch.core.plan.PallasUnsupported` for programs outside
  the planner's shape and the typed
  :class:`~repro_torch.core.interpreters.PlanUnsupported` for plans or
  dtypes outside the interpreter's declared capabilities.  Built-ins:
  ``"cuda"`` (the hand-written CUDA stencil kernel, K1) and
  ``"interp_torch"`` (its plain PyTorch version);
* ``backend="auto"`` (the default) — offer the plan to the stencil
  interpreter of the device (``"cuda"`` on a CUDA device; with
  ``device="cpu"``, its plain version ``"interp_torch"``) and fall back
  to ``"torch"``.  The CUDA kernel is offered every schedule over a
  (row, vector) loop order, split (multi-nest) ones included: on the
  card the emitter is bound by its launches.  The plain version is
  offered single-nest schedules, and split ones only when the program
  name has been registered as a measured stencil win with
  :func:`register_pallas_split_win`, as in the reference.  The probe
  falls back only on the named refusals: the planner's
  :class:`~repro_torch.core.plan.PallasUnsupported`, a
  :class:`~repro_torch.core.plancheck.PlanCheckError` under
  ``check_plans="error"``, the typed
  :class:`~repro_torch.core.interpreters.PlanUnsupported` capability
  refusal, and, off the card, the ``dim_sizes`` consult
  (:func:`~repro_torch.core.vecscan.auto_vec_reject`).  A failed build,
  a failed launch or a CUDA error raises; it never routes elsewhere.

Compiled results are cached at two levels: a fast path keyed on
(program signature, backend, dtype, device, build options, dim sizes,
layout mode) and, for every registry backend, a **plan-level** cache
keyed on (interpreter, :meth:`KernelPlan.cache_key`, dtype, device,
build options), so two differently-built programs that lower to
structurally equal plans share one executor while two interpreters
executing the *same* plan never collide.  The plan-level cache is
LRU-bounded (:func:`set_plan_cache_cap`) and, when
``plan_cache_dir=...`` is passed, becomes the L1 over a durable on-disk
L2 (:mod:`repro_torch.core.plancache`): a process that finds its
program's serialized plan on disk builds the interpreter straight from
the loaded IR and never invokes the analysis pipeline at all.
"""
from __future__ import annotations

import os
import warnings
from collections import OrderedDict
from typing import Optional, Union

import torch

from .codegen_torch import Generated, generate
from .dataflow import build_dataflow
from .fusion import fuse_inest_dag
from .infer import infer
from .interpreters import (PlanUnsupported, execute_plan, get_interpreter,
                           registered_interpreters, resolve_device)
from .layoutapply import apply_layout as run_layout_pass
from .layoutapply import render_apply, resolve_apply_mode
from .plan import KernelPlan, PallasUnsupported
from .plan import fn_key as _fn_key
from .plancheck import (PlanCheckError, PlanCheckWarning, _call_sizes,
                        check_plan, has_errors, resolve_check_mode)
from .planner import PallasGenerated, plan_pallas
from .reuse import StoragePlan, analyze_storage
from .rules import Program
from .vecscan import auto_vec_reject, scan_plan

#: The built-in backend names.  ``compile_program`` additionally
#: accepts any name in the plan-interpreter registry
#: (:func:`repro_torch.core.interpreters.registered_interpreters`).
BACKENDS = ("auto", "torch", "cuda")

#: Environment default for ``compile_program(plan_cache_dir=...)``.
PLAN_CACHE_DIR_ENV = "REPRO_PLAN_CACHE_DIR"

_CACHE: dict = {}
_PLAN_CACHE: "OrderedDict" = OrderedDict()
_PLAN_CACHE_CAP = 128

# Split (multi-nest) schedules that measured faster on the stencil
# kernel than on the fused-source emitter.  ``backend="auto"`` routes
# these programs to the stencil interpreter by name; everything else
# multi-nest keeps the emitter.  Empty by default, as in the reference.
PALLAS_SPLIT_WINS: set[str] = set()

#: Stencil interpreters that ``backend="auto"`` offers every plan the
#: planner lowers, split schedules included, with no ``dim_sizes``
#: consult.  On the card the emitter runs a Python iteration per row
#: and is bound by its launches: it measured hundreds of times slower
#: than the CUDA kernel on both split programs at 4096 x 2048, and at
#: sizes the reference's consult routes away, a block's region over
#: shared memory (the kernel then works from global scratch) or rows
#: under the lane-occupancy floor (PERF.md, §6).
AUTO_TAKES_EVERY_PLAN = frozenset({"cuda"})


def register_pallas_split_win(name: str) -> None:
    """Record that the named program's *split* schedule measured faster
    on the stencil kernel, so ``backend="auto"`` routes it there.

    The table is keyed by program *name*, so the default name is
    rejected — it would reroute every anonymously-built program.
    Cached ``backend="auto"`` compilations of the program are
    invalidated so the new routing takes effect on the next
    :func:`compile_program` call."""
    if name == "program":
        raise ValueError(
            "refusing to register the default program name 'program' as a "
            "split win: give the program an explicit name"
        )
    PALLAS_SPLIT_WINS.add(name)
    for key in [k for k in _CACHE if k[1] == "auto" and k[0][0] == name]:
        del _CACHE[key]


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
    """Drop every memoized compilation (all backends, both levels)."""
    _CACHE.clear()
    _PLAN_CACHE.clear()


def compile_cache_size() -> int:
    """Number of live entries in the signature-level compile cache."""
    return len(_CACHE)


def plan_cache_size() -> int:
    """Number of live entries in the plan-level compile cache."""
    return len(_PLAN_CACHE)


def plan_cache_cap() -> int:
    """Current LRU bound of the in-memory plan-level compile cache."""
    return _PLAN_CACHE_CAP


def set_plan_cache_cap(cap: int) -> int:
    """Re-bound the in-memory plan-level compile cache (LRU).

    Every executor entry pins its plan and closures (and, for the CUDA
    kernel, its launch), so the cache must not grow without bound in
    long-lived serving processes.  Lowering the cap evicts
    least-recently-used entries immediately; returns the previous cap
    so callers can restore it."""
    global _PLAN_CACHE_CAP
    if cap < 1:
        raise ValueError(f"plan cache cap must be >= 1, got {cap}")
    prev, _PLAN_CACHE_CAP = _PLAN_CACHE_CAP, int(cap)
    while len(_PLAN_CACHE) > _PLAN_CACHE_CAP:
        _PLAN_CACHE.popitem(last=False)
    return prev


def _build_plan(program: Program):
    idag = infer(program)
    plan = analyze_storage(fuse_inest_dag(build_dataflow(idag)))
    return idag, plan


def _itemsize(dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def auto_interpreter(device) -> str:
    """The stencil interpreter ``backend="auto"`` offers plans to on
    ``device``: the CUDA kernel on a CUDA device, its plain version on
    the CPU."""
    return "cuda" if torch.device(device).type == "cuda" else "interp_torch"


def _split_viable(name: str, interpreter: str) -> bool:
    return interpreter in AUTO_TAKES_EVERY_PLAN or name in PALLAS_SPLIT_WINS


def pallas_auto_viable(plan: StoragePlan,
                       interpreter: str = "interp_torch") -> bool:
    """Whether ``backend="auto"`` should offer this plan to the stencil
    interpreter ``interpreter`` (:func:`auto_interpreter`).

    Single-nest schedules over a >= 2-dim loop order always qualify
    (shapes the planner still rejects fail the probe with
    :class:`PallasUnsupported` and fall back to the emitter).
    Multi-nest (split) schedules qualify on the CUDA kernel
    (:data:`AUTO_TAKES_EVERY_PLAN`), and on the plain version only when
    the program is a registered measured win
    (:func:`register_pallas_split_win`), as in the reference."""
    if len(plan.schedule.program.loop_order) < 2:
        return False
    if len(plan.schedule.nests) == 1:
        return True
    return _split_viable(plan.schedule.program.name, interpreter)


def smem_report(kplan: KernelPlan, sizes: dict) -> dict:
    """``{call name: bytes}``: the per-block region (windows, locals,
    accumulators, plane windows of a row tile, ring) of the CUDA stencil
    kernel's own launch at ``sizes`` (``{size symbol: int}``), for every
    grid call whose sizes resolve.  The launch is chosen as
    :meth:`~repro_torch.kernels.stencil2d.emit.CallLayout.concretize`
    chooses it on an H100, which prefers tiles whose region fits shared
    memory; over ``SMEM_LIMIT`` the kernel keeps a block's region in
    global scratch.  :func:`explain` prints it; nothing routes on it.
    Raises :class:`PlanUnsupported` for a call outside the kernel's
    shape."""
    from ..kernels.stencil2d.emit import CallLayout
    out = {}
    for call in kplan.calls:
        if not call.has_grid:
            continue
        resolved = _call_sizes(kplan, call, sizes)
        if resolved is None:
            continue
        lay = CallLayout(call)
        run = lay.concretize(tuple(resolved), 1)
        out[call.name] = 4 * run.ints[lay.int_names.index("fast_floats")]
    return out


def _run_plancheck(kplan: KernelPlan, mode: str) -> None:
    """Gate a plan on the static analyzer per the resolved
    ``check_plans`` mode: ``"error"`` raises
    :class:`~repro_torch.core.plancheck.PlanCheckError` on
    error-severity findings, ``"warn"`` turns every finding into a
    :class:`~repro_torch.core.plancheck.PlanCheckWarning`, ``"off"``
    skips the analyses.  The analyzer's size check (PC003) is a TPU
    VMEM budget and is not run: the CUDA kernel keeps a block's region
    in global scratch where it outgrows shared memory."""
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


def _emit_plan(kplan: KernelPlan, plan: Optional[StoragePlan], *,
               interpreter: str, dtype, device, options: dict,
               use_cache=True, check="warn", dim_sizes=None,
               apply_mode="off") -> PallasGenerated:
    """Build (or fetch) the named interpreter's executor for a finished
    kernel plan.

    Memoized on (interpreter, :meth:`KernelPlan.cache_key`, dtype,
    device, build options), LRU-bounded (:func:`set_plan_cache_cap`), so
    programs lowering to structurally equal plans share one executor
    per interpreter — whether the plan came from the planner or from
    the on-disk cache.  Static analysis (``check``) runs at build time;
    a plan-cache hit is a plan that already passed.

    ``apply_mode`` (a resolved ``apply_layout`` mode) runs the
    LayoutApply pass over the plan first — only for layout-aware
    interpreters, and only when not ``"off"``.  The transformed plan's
    ``applied_layout`` record makes its cache key distinct; the original
    plan is kept on the artifact (``.base_plan``) so the on-disk cache
    always persists the *untransformed* form."""
    spec = get_interpreter(interpreter)
    base_plan = kplan
    layout_result = None
    if apply_mode != "off" and spec.layout_aware:
        layout_result = run_layout_pass(
            kplan, mode=apply_mode,
            sizes=dict(dim_sizes) if dim_sizes else None)
        kplan = layout_result.plan
    pkey = (interpreter, kplan.cache_key(), str(dtype), str(device),
            tuple(sorted(options.items())))
    if use_cache:
        hit = _PLAN_CACHE.get(pkey)
        if hit is not None:
            _PLAN_CACHE.move_to_end(pkey)
            if hit.plan is None and plan is not None:
                # a disk-restored entry lacks the analysis-side
                # StoragePlan; this caller just built one — upgrade the
                # shared artifact so .schedule works everywhere
                hit.plan = plan
            return hit
    _run_plancheck(kplan, check)
    # the shared host half runs the capability check, raising the typed
    # PlanUnsupported for plans outside the declared feature set
    fn = execute_plan(kplan, interpreter=interpreter, dtype=dtype,
                      device=device, **options)
    gen = PallasGenerated(kplan, fn, plan, interpreter=interpreter,
                          device=device, base_plan=base_plan,
                          layout_result=layout_result)
    if use_cache:
        _PLAN_CACHE[pkey] = gen
        while len(_PLAN_CACHE) > _PLAN_CACHE_CAP:
            _PLAN_CACHE.popitem(last=False)
    return gen


def _auto_reject(kplan: KernelPlan, dim_sizes, dtype,
                 interpreter: str) -> Optional[str]:
    """The ``dim_sizes`` consult of ``"auto"``: the vectorization
    model's :func:`~repro_torch.core.vecscan.auto_vec_reject` (lane
    occupancy under ``REPRO_VEC_MIN_OCCUPANCY``, redundant-load ratio
    over the opt-in ``REPRO_VEC_AUTO_MAX_RATIO``); ``None`` without
    sizes, and for the CUDA kernel (:data:`AUTO_TAKES_EVERY_PLAN`)."""
    if not dim_sizes or interpreter in AUTO_TAKES_EVERY_PLAN:
        return None
    return auto_vec_reject(kplan, dict(dim_sizes),
                           dtype_bytes=_itemsize(dtype))


def _auto_emit(kplan: KernelPlan, plan: Optional[StoragePlan], *, dtype,
               device, options: dict, dim_sizes=None, **flags):
    """Offer a kernel plan to the device's stencil interpreter
    (:func:`auto_interpreter`) with the build options it takes (the CUDA
    kernel's ``chunk``/``plane_chunk`` mean nothing to its plain
    version); None when the ``dim_sizes`` consult (:func:`_auto_reject`),
    the static analyzer under ``check="error"`` or the interpreter's
    typed :class:`PlanUnsupported` refuses it.  Anything else raises."""
    interp = auto_interpreter(device)
    try:
        if _auto_reject(kplan, dim_sizes, dtype, interp):
            return None
        takes = get_interpreter(interp).flags
        return _emit_plan(kplan, plan, interpreter=interp, dtype=dtype,
                          device=device,
                          options={k: v for k, v in options.items()
                                   if k in takes},
                          dim_sizes=dim_sizes, **flags)
    except (PlanCheckError, PlanUnsupported):
        return None


def _pallas_auto_probe(plan, idag, **flags):
    """The single auto-routing probe shared by :func:`compile_program`
    and :func:`explain`: the stencil interpreter's executor
    (:func:`_auto_emit`) if the plan is viable and the planner lowers
    it, else None (fall back to ``"torch"``)."""
    if not pallas_auto_viable(plan, auto_interpreter(flags["device"])):
        return None
    try:
        kplan = plan_pallas(plan, idag)
    except PallasUnsupported:
        return None
    return _auto_emit(kplan, plan, **flags)


def _load_plan_from_disk(program: Program, backend: str, plan_cache_dir,
                         device) -> Optional[KernelPlan]:
    """L2 lookup: fetch the program's serialized plan, honoring auto's
    routing rules (a pre-warmed multi-nest plan must not flip an
    ``auto`` compilation that would otherwise take the emitter — split
    schedules still require :func:`pallas_auto_viable`'s rule)."""
    from .plancache import PlanCache, program_plan_key
    try:
        kplan = PlanCache(plan_cache_dir).get(program_plan_key(program))
    except OSError:  # uncreatable/unreadable cache dir: cold compile
        return None
    if kplan is None:
        return None
    if backend == "auto" and len(kplan.calls) != 1 \
            and not _split_viable(program.name, auto_interpreter(device)):
        return None
    return kplan


def _store_plan_to_disk(program: Program, kplan: KernelPlan,
                        plan_cache_dir, only_if_missing: bool = False) -> None:
    """L2 fill: persist a planned program (best-effort — plans whose
    callables have no stable spec, and filesystem failures, are
    skipped, not errors).  ``only_if_missing`` makes the fill
    idempotent for hot paths that revisit the same program."""
    from .plancache import PlanCache, program_plan_key
    try:
        cache = PlanCache(plan_cache_dir)
        key = program_plan_key(program)
        if only_if_missing and cache.has(key):
            return
        cache.put(key, kplan)
    except OSError:
        pass


def _disk_compile(program, backend, plan_cache_dir, **flags):
    """The L2 path: an executor built from the program's plan on disk,
    or ``None`` (a miss, or — under ``"auto"`` — a plan the probe's
    refusals send to the emitter)."""
    kplan = _load_plan_from_disk(program, backend, plan_cache_dir,
                                 flags["device"])
    if kplan is None:
        return None
    if backend == "auto":
        return _auto_emit(kplan, None, **flags)
    return _emit_plan(kplan, None, interpreter=backend, **flags)


def _attach_vec_report(gen, want: bool, dim_sizes, dtype):
    """Annotate a plan-backed artifact with its
    :class:`~repro_torch.core.vecscan.VecReport` when the compilation
    asked for one.  A no-op for the fused-source emitter (no kernel plan
    exists); recomputed per request so a later call carrying concrete
    ``dim_sizes`` upgrades a cached artifact's symbolic report."""
    if want and isinstance(gen, PallasGenerated):
        gen.vec_report = scan_plan(
            gen.kernel_plan,
            sizes=dict(dim_sizes) if dim_sizes else None,
            dtype_bytes=_itemsize(dtype))
    return gen


def compile_program(
    program: Program,
    backend: str = "auto",
    *,
    dtype=torch.float32,
    device=None,
    use_cache: bool = True,
    plan_cache_dir=None,
    check_plans: Optional[str] = None,
    dim_sizes=None,
    vec_report: bool = False,
    apply_layout: Optional[str] = None,
    **options,
) -> Union[Generated, PallasGenerated]:
    """Compile ``program`` through the HFAV pipeline onto a backend.

    ``backend`` is ``"auto"`` (the default), ``"torch"`` (the
    fused-source emitter) or a registered interpreter (``"cuda"``,
    ``"interp_torch"``); see the module docstring.  ``device`` is where
    the compiled ``fn`` runs: the current CUDA device when omitted (and
    an error without CUDA); pass ``device="cpu"`` to run on the CPU.
    ``options`` are the interpreter's build options (the ``"cuda"``
    kernel takes ``chunk``, its row-chunk length, and ``plane_chunk``,
    the plane-chunk length of a call with plane windows; under
    ``"auto"`` they apply only where the plan goes to the kernel).
    Results are memoized; pass ``use_cache=False`` to force a rebuild.

    ``plan_cache_dir`` names a durable on-disk plan cache
    (:mod:`repro_torch.core.plancache`): plan-bound compilations first
    try to load the program's serialized :class:`KernelPlan` from there
    — a hit skips the entire analysis pipeline (inference, fusion,
    storage, planning; the loaded plan is re-validated) — and freshly
    planned programs are persisted back, so a second process compiles
    warm.  ``use_cache`` governs only the in-memory caches.  When
    omitted, ``REPRO_PLAN_CACHE_DIR`` supplies the default.

    ``check_plans`` gates every plan on the static analyzer
    (:mod:`repro_torch.core.plancheck`): ``"warn"`` (the default,
    overridable via ``REPRO_CHECK_PLANS``), ``"error"`` (raises
    :class:`~repro_torch.core.plancheck.PlanCheckError`;
    ``backend="auto"`` falls back to the emitter instead) or ``"off"``.

    ``dim_sizes`` (``{size symbol: int}``, e.g. ``{"Nj": 512}``)
    declares the intended problem size: off the card,
    ``backend="auto"`` then routes plans that the vectorization model
    rejects (:func:`~repro_torch.core.vecscan.auto_vec_reject`) to the
    emitter; the CUDA kernel takes every size.

    ``vec_report=True`` attaches the vectorization analyzer's
    :class:`~repro_torch.core.vecscan.VecReport` to the returned
    artifact's ``.vec_report`` (plan-backed backends only).

    ``apply_layout`` (``"off"``/``"auto"``/``"force"``; ``None`` defers
    to ``REPRO_APPLY_LAYOUT``, defaulting to ``"off"``) gates the
    LayoutApply pass (:mod:`repro_torch.core.layoutapply`): when the
    target interpreter is layout-aware (``"interp_torch"``; the CUDA
    kernel is not), VecScan's hints are realized on the plan before it
    builds.  The on-disk plan cache always stores the untransformed
    plan."""
    if backend == "jax":
        raise ValueError(
            "backend 'jax' is the JAX package's fused-source emitter; the "
            "port's is backend 'torch'")
    if backend in ("auto", "torch"):
        spec = None
    else:
        try:
            spec = get_interpreter(backend)
        except ValueError:
            raise ValueError(
                f"unknown backend {backend!r}; expected 'auto', 'torch' or "
                f"a registered interpreter: {registered_interpreters()}"
            ) from None
    if backend == "torch" and options:
        raise TypeError(f"backend 'torch' takes no build option(s) "
                        f"{sorted(options)}")
    dev = resolve_device(device)
    if backend == "auto":
        unknown = set(options) - get_interpreter("cuda").flags
        if unknown:
            raise TypeError(f"backend 'auto' takes no build option(s) "
                            f"{sorted(unknown)}")
    check = resolve_check_mode(check_plans)
    apply_mode = resolve_apply_mode(apply_layout)
    if plan_cache_dir is None:
        plan_cache_dir = os.environ.get(PLAN_CACHE_DIR_ENV) or None
    sizes_key = tuple(sorted(dim_sizes.items())) if dim_sizes else None
    layout_aware = backend == "auto" or (spec is not None
                                         and spec.layout_aware)
    key = (program_signature(program), backend, str(dtype), str(dev),
           tuple(sorted(options.items())), sizes_key,
           apply_mode if layout_aware else "off")
    if use_cache:
        hit = _CACHE.get(key)
        if hit is not None:
            if plan_cache_dir is not None and isinstance(hit,
                                                         PallasGenerated):
                # the program compiled before this call named a cache
                # dir: back-fill the L2 so the next process runs warm
                _store_plan_to_disk(program, hit.base_plan or hit.kernel_plan,
                                    plan_cache_dir, only_if_missing=True)
            return _attach_vec_report(hit, vec_report, dim_sizes, dtype)
    flags = dict(dtype=dtype, device=dev, options=options,
                 use_cache=use_cache, check=check, dim_sizes=dim_sizes,
                 apply_mode=apply_mode)
    if plan_cache_dir is not None and backend != "torch":
        # disk-restored artifacts carry no StoragePlan, so they live
        # under a marked key: a later compile *without* plan_cache_dir
        # must rebuild the full artifact, not inherit the degraded one
        dkey = key + ("disk",)
        if use_cache:
            hit = _CACHE.get(dkey)
            if hit is not None:
                return _attach_vec_report(hit, vec_report, dim_sizes,
                                          dtype)
        gen = _disk_compile(program, backend, plan_cache_dir, **flags)
        if gen is not None:
            if use_cache:
                _CACHE[dkey] = gen
            return _attach_vec_report(gen, vec_report, dim_sizes, dtype)
    idag, plan = _build_plan(program)
    if backend == "torch":
        gen = generate(plan, idag, dtype=dtype, device=dev)
    elif backend == "auto":
        gen = _pallas_auto_probe(plan, idag, **flags)
        if gen is None:
            gen = generate(plan, idag, dtype=dtype, device=dev)
    else:
        gen = _emit_plan(plan_pallas(plan, idag), plan, interpreter=backend,
                         **flags)
    if plan_cache_dir is not None and isinstance(gen, PallasGenerated):
        _store_plan_to_disk(program, gen.base_plan or gen.kernel_plan,
                            plan_cache_dir)
    if use_cache:
        _CACHE[key] = gen
    return _attach_vec_report(gen, vec_report, dim_sizes, dtype)


class BatchedGenerated:
    """A compiled program mapped over a leading batch axis.

    Wraps the single-example artifact (``.gen``, a
    :class:`~repro_torch.core.codegen_torch.Generated` or
    :class:`~repro_torch.core.planner.PallasGenerated` from
    :func:`compile_program`) with a batched callable: ``fn(arrays)``
    takes a dict of input arrays each carrying one extra *leading* batch
    axis (the same batch width on every input) and returns the
    per-store output dict with the same leading axis.  Built by
    :func:`compile_batched`; PlanServe (:mod:`repro_torch.serve.plans`)
    executes every micro-batch through one of these."""

    def __init__(self, gen, fn, *, backend: str):
        self.gen = gen
        self.fn = fn
        self.backend = backend

    def __repr__(self):
        return f"BatchedGenerated(backend={self.backend!r}, gen={self.gen!r})"


def compile_batched(
    program: Program,
    backend: str = "auto",
    **kwargs,
) -> BatchedGenerated:
    """Compile ``program`` and map the result over a leading batch axis.

    The single-example compilation goes through :func:`compile_program`
    (all of its keyword flags — ``dtype``, ``device``,
    ``plan_cache_dir``, ``dim_sizes``, build options … — pass through
    unchanged, so the on-disk plan cache and the in-memory caches behave
    exactly as for unbatched compiles).  The batch is mapped by a loop
    over the examples, each run through the single-example ``fn``, and
    a ``torch.stack`` of their outputs, so the result is bit-identical
    to per-example calls by construction.  There is no ``jit`` flag:
    nothing is traced, and each example is its own launch of the
    backend (the CUDA kernel has no batch grid axis)."""
    gen = compile_program(program, backend, **kwargs)

    def fn(arrays: dict) -> dict:
        widths = {len(a) for a in arrays.values()}
        if len(widths) != 1 or 0 in widths:
            raise ValueError(f"batched inputs need one nonzero leading "
                             f"batch width, got {sorted(widths)}")
        outs = [gen.fn(**{k: a[b] for k, a in arrays.items()})
                for b in range(widths.pop())]
        return {k: torch.stack([o[k] for o in outs]) for k in outs[0]}

    return BatchedGenerated(gen, fn, backend=backend)


def explain(program: Program, *, dtype=torch.float32, device=None,
            verbose: bool = False, dim_sizes=None,
            apply_layout: Optional[str] = None) -> str:
    """Human-readable transformation report (the paper's debugging output).

    The keyword flags mirror :func:`compile_program` and feed the same
    shared probe (:func:`_pallas_auto_probe`), so the reported
    ``auto backend`` is exactly what ``backend="auto"`` would pick for a
    compilation with those flags on ``device`` — including split-win
    routing and (when ``dim_sizes`` is given) the size consult.

    ``verbose=True`` appends the rendered
    :class:`~repro_torch.core.plan.KernelPlan` when the probe lowered
    one — the declarative contract the interpreter will execute — then,
    when ``dim_sizes`` resolves them, the per-block bytes of the CUDA
    kernel's launch (:func:`smem_report`) against the shared memory a
    block may take, the vectorization analysis
    (:func:`repro_torch.core.vecscan.scan_plan`) and the LayoutApply
    report (:func:`repro_torch.core.layoutapply.apply_layout` run in
    the resolved ``apply_layout`` mode): which hints the pass applied,
    which it skipped and why, which stay advisory, and the predicted
    redundant-load ratio before and after."""
    dev = resolve_device(device)
    idag, plan = _build_plan(program)
    schedule = plan.schedule
    dag = schedule.dag
    gen = _pallas_auto_probe(plan, idag, dtype=dtype, device=dev,
                             options={}, dim_sizes=dim_sizes)
    backend = gen.interpreter if gen is not None else "torch"
    lines = [
        f"program: {program.name}",
        f"raps: {len(idag.raps)}  groups: {len(dag.groups)}  "
        f"fused nests: {schedule.n_toplevel()}",
        f"auto backend: {backend}",
        "--- fused schedule ---",
        schedule.pretty(),
        "--- storage plan ---",
        plan.summary(),
    ]
    if verbose:
        lines.append("--- kernel plan ---")
        if gen is not None:
            lines.append(gen.kernel_plan.render())
            lines.append("--- shared memory estimate ---")
            if dim_sizes:
                from ..kernels.stencil2d.emit import SMEM_LIMIT
                for name, nbytes in smem_report(gen.kernel_plan,
                                                dict(dim_sizes)).items():
                    where = ("shared memory" if nbytes <= SMEM_LIMIT
                             else "global scratch")
                    lines.append(f"  {name}: {nbytes} B a block, in "
                                 f"{where} (shared memory holds "
                                 f"{SMEM_LIMIT} B)")
            else:
                lines.append("  (pass dim_sizes for the CUDA kernel's "
                             "launch)")
            lines.append("--- vectorization ---")
            vrep = scan_plan(gen.kernel_plan,
                             sizes=dict(dim_sizes) if dim_sizes else None,
                             dtype_bytes=_itemsize(dtype))
            lines.extend(vrep.render())
            lines.append("--- layout apply ---")
            mode = resolve_apply_mode(apply_layout)
            lres = run_layout_pass(
                gen.kernel_plan, mode=mode,
                sizes=dict(dim_sizes) if dim_sizes else None)
            lines.extend(render_apply(lres, mode))
        else:
            lines.append("(auto picked the fused-source emitter: no "
                         "stencil plan)")
    return "\n".join(lines)
