"""The plan-interpreter registry and the shared host half.

The port's counterpart of ``repro.core.interpreters``.  An interpreter
is a **pluggable registration** — a name mapped to an
:class:`InterpreterSpec` carrying a declared *capability set* (which
:data:`~repro_torch.core.plan.PLAN_FEATURES` tags it can execute), the
dtypes it builds for, and a ``build_call`` that concretizes one
:class:`~repro_torch.core.plan.CallPlan` for a problem size.  The
engine (:func:`repro_torch.core.engine.compile_program`) resolves its
``backend`` through :func:`get_interpreter`.

Two interpreters self-register on first use:

* ``"cuda"`` — the hand-written CUDA stencil kernel
  (:mod:`repro_torch.kernels.stencil2d.kernel`), the port of the JAX
  package's Pallas stencil interpreter;
* ``"interp_torch"`` — the plain PyTorch plan interpreter
  (:mod:`repro_torch.core.interp_torch`): the same plan semantics as a
  Python loop over the linearized grid, the kernel's plain version.

Every ``build_call`` honors the **output contract** of the reference
Pallas kernel — row outputs ``(*grid, steps_j, ni)``, carried
accumulators ``(1, width)``, kept-prefix accumulators
``(*grid[:n_kept], width)`` — because the host half here
(:func:`execute_plan`: size resolution through axiom shape contracts,
environment threading, and the :func:`assemble` trim/seat/lane-reduce
rules) is shared by every interpreter verbatim.  An interpreter that
declares ``seats`` (the CUDA kernel) writes each ``external`` output
:func:`seatable` admits straight into its goal array instead, and the
host half takes that array as it is.  An interpreter that
declares a ``build_batched`` runs a batch of examples (a leading batch
axis on every array, or each array as the sequence of its examples'
tensors, read where they lie) through one host half and one launch of
each call
(:func:`execute_plan` with ``batched=True``): the counterpart of the
reference's ``vmap`` of its host half, whose batching rule turns the
Pallas call into one ``pallas_call`` with a leading batch grid axis.

Capability or dtype mismatches raise the typed :class:`PlanUnsupported`
(a :class:`~repro_torch.core.plan.PallasUnsupported` subclass); unknown
names raise ``ValueError`` listing what *is* registered.
"""
from __future__ import annotations

import importlib
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np
import torch

from .. import obs
from .plan import (PLAN_FEATURES, CallPlan, KernelPlan, OutputPlan,
                   PallasUnsupported)
from .runtime import lane_reduce

#: The reference Pallas kernel's capability set (unit-stride reads, no
#: LayoutApply constructs), declared by the CUDA stencil kernel.
STENCIL_CAPABILITIES = PLAN_FEATURES - frozenset({
    "strided_reads", "vec_loads", "align_pad", "lane_block"})


class PlanUnsupported(PallasUnsupported):
    """A validated plan demands features outside an interpreter's
    declared capability set — a typed refusal (never a miscompile),
    raised by :func:`check_capabilities` before anything builds."""


@dataclass(frozen=True)
class InterpreterSpec:
    """One registered plan interpreter.

    ``build_call(call, sizes, dtype, device=..., **options)``
    concretizes a :class:`~repro_torch.core.plan.CallPlan` to
    ``(fn, steps_j)`` under the shared padded-output contract (see the
    module docstring).  ``capabilities`` is the subset of
    :data:`~repro_torch.core.plan.PLAN_FEATURES` the interpreter
    executes; ``dtypes`` the torch dtypes it builds for; ``flags``
    names the build options ``build_call`` takes.  ``layout_aware``
    declares that ``build_call`` executes the constructs the LayoutApply
    pass (:mod:`repro_torch.core.layoutapply`) writes (carried-vector
    slots, ``align_pad``, ``lane_block``); the engine runs the pass only
    for layout-aware interpreters (``"interp_torch"``), and the CUDA
    kernel, like the reference's Pallas kernel, is not one.

    ``build_batched`` (optional, the same signature as ``build_call``)
    concretizes a call over a batch: its ``fn`` takes every input with
    one leading batch axis, or as the sequence of its examples' tensors,
    and returns every padded output with a leading batch axis, each
    example's bits those of ``build_call``'s ``fn`` on that example.  The
    CUDA kernel declares one (one launch a batch); an interpreter without
    one runs a batch example by example
    (:func:`repro_torch.core.engine.compile_batched`).

    ``seats`` declares that ``build_call`` and ``build_batched`` take
    ``seated=True`` and then return each output :func:`seatable` admits
    as the environment array :func:`assemble` would make of its padded
    one (its goal's shape, borders included), so the host half takes it
    as it is.  The CUDA kernel declares it; the plain versions do not."""

    name: str
    build_call: Callable = field(compare=False)
    capabilities: frozenset = frozenset()
    dtypes: frozenset = frozenset({torch.float32})
    flags: frozenset = frozenset()
    description: str = ""
    layout_aware: bool = False
    build_batched: Optional[Callable] = field(default=None, compare=False)
    seats: bool = False


_REGISTRY: dict[str, InterpreterSpec] = {}

#: Modules that register the built-in interpreters at import time,
#: loaded lazily on first registry use (module-level imports here would
#: be circular: both interpreters import this module).
_BUILTIN_MODULES = ("repro_torch.kernels.stencil2d.kernel",
                    "repro_torch.core.interp_torch")
_builtins_loaded = False


def _ensure_builtins() -> None:
    global _builtins_loaded
    if _builtins_loaded:
        return
    _builtins_loaded = True
    for mod in _BUILTIN_MODULES:
        importlib.import_module(mod)


def register_interpreter(spec: InterpreterSpec) -> None:
    """Register (or replace) a plan interpreter under ``spec.name``.

    Unknown capability tags are rejected immediately — a typo'd tag
    would otherwise silently widen what the capability check lets
    through."""
    bad = spec.capabilities - PLAN_FEATURES
    if bad:
        raise ValueError(
            f"interpreter {spec.name!r} declares unknown capability "
            f"tags {sorted(bad)}; known tags: {sorted(PLAN_FEATURES)}")
    _REGISTRY[spec.name] = spec


def unregister_interpreter(name: str) -> None:
    """Remove a registered interpreter (test isolation helper)."""
    _REGISTRY.pop(name, None)


def registered_interpreters() -> tuple[str, ...]:
    """Sorted names of every registered interpreter (built-ins are
    loaded on first call)."""
    _ensure_builtins()
    return tuple(sorted(_REGISTRY))


def get_interpreter(name: str) -> InterpreterSpec:
    """Resolve a registered interpreter by name; unknown names raise
    ``ValueError`` listing what is registered."""
    _ensure_builtins()
    spec = _REGISTRY.get(name)
    if spec is None:
        raise ValueError(
            f"unknown plan interpreter {name!r}; registered: "
            f"{registered_interpreters()}")
    return spec


def check_capabilities(spec: InterpreterSpec, kplan: KernelPlan,
                       dtype=torch.float32) -> None:
    """Raise :class:`PlanUnsupported` when ``kplan`` demands feature
    tags outside ``spec.capabilities`` (see
    :meth:`~repro_torch.core.plan.KernelPlan.features`), or ``dtype``
    is not one the interpreter builds for."""
    missing = kplan.features() - spec.capabilities
    if missing:
        raise PlanUnsupported(
            f"plan {kplan.program!r} requires features {sorted(missing)} "
            f"outside interpreter {spec.name!r} capabilities")
    if dtype not in spec.dtypes:
        raise PlanUnsupported(
            f"interpreter {spec.name!r} builds for dtypes "
            f"{sorted(str(d) for d in spec.dtypes)}, not {dtype}")


# ---------------------------------------------------------------------------
# Shared build-time plan checks (every interpreter's build_call prologue)
# ---------------------------------------------------------------------------

def require_linked_fns(call: CallPlan) -> None:
    """Reject a call whose step/host/reduce fn indices point past its
    fn table — the signature of a deserialized plan that was never
    re-linked to its kernel callables."""
    fn_refs = [s.fn_idx for s in call.steps]
    fn_refs += [h.fn_idx for h in call.host_pre + call.host_post]
    fn_refs += [o.reduce_idx for o in call.outputs
                if o.reduce_idx is not None]
    if fn_refs and max(fn_refs) >= len(call.fns):
        raise ValueError(
            f"call {call.name}: plan references fn index {max(fn_refs)} "
            f"but the fn table has {len(call.fns)} entries — a "
            f"deserialized plan must re-link its kernel callables "
            f"(KernelPlan.from_dict / repro_torch.core.plan.fn_from_spec)")


def require_hazard_free(call: CallPlan) -> None:
    """Reject the hazards no interpreter can execute meaningfully.

    This duplicates only the *certain* subset of the static analyzer
    (:mod:`repro_torch.core.plancheck`) — reads whose mod-``stages`` slot
    arithmetic is guaranteed to alias a different row/plane, and local
    reads with no preceding write (a ``KeyError`` inside the traced
    kernel body otherwise).  The full analyzer additionally proves
    halo coverage and warm-up validity; run
    ``compile_program(check_plans="error")`` for those."""
    if not call.has_grid:
        return
    windows = {w.name: w for w in call.windows}
    inputs = {f"in_{i.name}": i for i in call.inputs if not i.scalar}
    # carried-vector loads are window reads too: the fresh load each
    # grid step must hit a live slot (``vec:`` register reads
    # themselves are slot-bounded by KernelPlan.validate)
    for v in call.vloads:
        ispec = inputs.get(v.src)
        if ispec is None:
            continue  # validate() rejects non-input vload sources
        if not ispec.plane:
            if not (ispec.lead - ispec.stages < v.j_off <= ispec.lead):
                raise ValueError(
                    f"call {call.name}: vload {v.name} reads row "
                    f"j{v.j_off:+d} of {v.src}; the mod-slot arithmetic "
                    f"aliases it outside "
                    f"(j{ispec.lead - ispec.stages:+d}, "
                    f"j{ispec.lead:+d}] (PlanCheck PC002/PC005)")
        elif not (ispec.p_lead - ispec.p_stages
                  < v.p_off <= ispec.p_lead):
            raise ValueError(
                f"call {call.name}: vload {v.name} reads plane "
                f"p{v.p_off:+d} of {v.src}; the mod-slot arithmetic "
                f"aliases it outside "
                f"(p{ispec.p_lead - ispec.p_stages:+d}, "
                f"p{ispec.p_lead:+d}] (PlanCheck PC002/PC005)")
    produced_lead: dict[str, int] = {}
    local_seen: set[str] = set()
    for step in call.steps:
        for rd in step.reads:
            if rd.src.startswith("local:"):
                if rd.src[6:] not in local_seen:
                    raise ValueError(
                        f"call {call.name}: step {step.op} reads "
                        f"{rd.src} before any step writes it "
                        f"(PlanCheck PC001)")
                continue
            lead = stages = None
            ispec = inputs.get(rd.src)
            if ispec is not None and not ispec.plane:
                lead, stages = ispec.lead, ispec.stages
            elif ispec is not None and rd.p_off != ispec.p_lead:
                if not (ispec.p_lead - ispec.p_stages
                        < rd.p_off <= ispec.p_lead):
                    raise ValueError(
                        f"call {call.name}: step {step.op} reads plane "
                        f"p{rd.p_off:+d} of {rd.src}; the mod-slot "
                        f"arithmetic aliases it outside "
                        f"(p{ispec.p_lead - ispec.p_stages:+d}, "
                        f"p{ispec.p_lead:+d}] (PlanCheck PC002/PC005)")
            w = windows.get(rd.src)
            if w is not None and not w.plane and rd.src in produced_lead:
                lead, stages = produced_lead[rd.src], w.stages
            if lead is not None and not (lead - stages < rd.j_off <= lead):
                raise ValueError(
                    f"call {call.name}: step {step.op} reads row "
                    f"j{rd.j_off:+d} of {rd.src}; the mod-slot "
                    f"arithmetic aliases it outside "
                    f"(j{lead - stages:+d}, j{lead:+d}] "
                    f"(PlanCheck PC002/PC005)")
        for targets in step.writes:
            for kind, tgt in targets:
                if kind == "local":
                    local_seen.add(str(tgt))
                elif kind == "buf":
                    produced_lead.setdefault(str(tgt), step.lead)


# ---------------------------------------------------------------------------
# The shared host half: device resolution, size resolution, environment
# threading, output assembly (the plan's trim/seat rules) — identical for
# every interpreter because every build_call honors the same contract.
# ---------------------------------------------------------------------------

def resolve_device(device=None) -> torch.device:
    """The device a compiled program runs on: ``device`` when given,
    else the current CUDA device.  A ``"cuda"`` without an index is the
    current CUDA device too, with its index, so it compares equal to the
    device of the tensors made on it.  Without CUDA, ``device=None``
    raises: the port never falls back to the CPU unless asked to."""
    if device is not None:
        dev = torch.device(device)
        if dev.type == "cuda" and dev.index is None \
                and torch.cuda.is_available():
            return torch.device("cuda", torch.cuda.current_device())
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on "
            "the CPU")
    return torch.device("cuda", torch.cuda.current_device())


def as_tensor(x, dtype, device) -> torch.Tensor:
    """``x`` (a tensor, numpy array or number) as a contiguous tensor of
    ``dtype`` on ``device``."""
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(np.ascontiguousarray(x))
    return torch.as_tensor(x, dtype=dtype, device=device).contiguous()


def _examples(name: str, seq, dtype, device) -> tuple:
    """A batch's input ``name`` given as the sequence of its examples'
    tensors, checked: one shape (the first example's), ``dtype`` and
    ``device``, each contiguous; raises ``ValueError`` otherwise."""
    first = seq[0]
    for b, t in enumerate(seq):
        if not (isinstance(t, torch.Tensor) and t.shape == first.shape
                and t.dtype == dtype and t.device == device
                and t.is_contiguous()):
            raise ValueError(f"input {name!r}: example {b} is not a "
                             f"contiguous {dtype} tensor on {device} of "
                             f"the first example's shape")
    return tuple(seq)


def _lane_permute(arr, p, inverse: bool = False):
    """Apply one size-specialized :class:`~repro_torch.core.plan.LanePass`
    along the last axis: de-interleave ``old col c -> (c % stride) *
    (width // stride) + c // stride`` (``inverse=True`` undoes it).
    The lane width is asserted at runtime — the permutation was
    specialized to it by the layout pass."""
    if arr.shape[-1] != p.width:
        raise ValueError(
            f"lane pass on {p.array!r}: array lane width "
            f"{arr.shape[-1]} != the size-specialized pass width "
            f"{p.width}")
    lead = tuple(arr.shape[:-1])
    m = p.width // p.stride
    if inverse:
        return arr.reshape(*lead, p.stride, m).transpose(-1, -2) \
                  .reshape(*lead, p.width)
    return arr.reshape(*lead, m, p.stride).transpose(-1, -2) \
              .reshape(*lead, p.width)


def _run_host(call: CallPlan, hs, env: dict) -> None:
    vals = call.fns[hs.fn_idx](*[env[n] for n in hs.reads])
    if len(hs.writes) == 1:
        vals = (vals,)
    for name, val in zip(hs.writes, vals):
        env[name] = val


def _outer_trim(out: OutputPlan, call: CallPlan, n_outs: tuple[int, ...],
                n_dims: int) -> tuple[slice, ...]:
    """Slices dropping warm-up/drain tiles of the first ``n_dims`` outer
    grid dims, keeping the output's canonical extent ``[lo, N_d + hi)``
    (a producer running ``outer_lead`` tiles ahead wrote its blocks that
    many tiles early)."""
    o_lo = call.outer_lo
    idx = []
    for d in range(n_dims):
        lead = out.outer_lead[d] if out.outer_lead else 0
        s0 = out.outer_lo[d] - lead - o_lo[d]
        cnt = n_outs[d] + out.outer_hi[d] - out.outer_lo[d]
        idx.append(slice(s0, s0 + cnt))
    return tuple(idx)


def _outer_seat(out: OutputPlan, n_outs: tuple[int, ...],
                n_dims: int) -> tuple[slice, ...]:
    """Slices seating a trimmed value at its goal origin inside
    full-size ``[0, N_d)`` outer dims."""
    return tuple(
        slice(out.outer_lo[d], n_outs[d] + out.outer_hi[d])
        for d in range(n_dims)
    )


def _seated(shape, seat, part) -> torch.Tensor:
    res = torch.zeros(shape, dtype=part.dtype, device=part.device)
    res[seat] = part
    return res


def seatable(call: CallPlan, out: OutputPlan) -> bool:
    """Whether a kernel may store ``out`` at its seat in the goal array
    instead of the padded contract's rows: an ``external`` output whose
    goal rows and outer tiles the call's padded grid covers, so that the
    inverse of :func:`assemble`'s trim (padded row ``jid`` is goal row
    ``jid + call.x_lo + out.lead``, padded tile ``t`` goal tile ``t +
    call.outer_lo + out.outer_lead``) meets every element of the seat.
    The rule reads the plan alone, never the sizes."""
    if out.kind != "external":
        return False
    if not call.x_lo + out.lead <= out.j_lo \
            or not out.j_hi - out.lead <= call.x_hi_off:
        return False
    for d in range(call.n_outer):
        lead = out.outer_lead[d] if out.outer_lead else 0
        if not call.outer_lo[d] + lead <= out.outer_lo[d] \
                or not out.outer_hi[d] - lead <= call.outer_hi_off[d]:
            return False
    return True


def assemble(call: CallPlan, out: OutputPlan, padded, nj: int, ni: int,
             n_outs: tuple[int, ...], *, lanes: bool = False,
             batched: bool = False):
    """Map one padded device output back to its environment array: trim
    warm-up/drain rows and tiles, re-seat goal origins, lane-reduce
    accumulators whose vector dim was folded.  ``lanes=True`` stops
    before the lane reduction (and its seat): an accumulator's trimmed
    rows as the interpreter wrote them, which is how a kernel is held
    against its plain version call by call.  ``batched=True`` maps a
    padded output with a leading batch axis to arrays with it, each
    example as alone (the lane reduction is elementwise across the
    examples)."""
    n_out = call.n_outer
    b = (slice(None),) if batched else ()
    lead = tuple(padded.shape[:1]) if batched else ()
    reduce_fn = call.fns[out.reduce_idx] if out.reduce_idx is not None \
        else None
    if lanes:
        reduce_fn = None
    if out.kind == "acc":
        if out.n_kept:
            # (*kept grid tiles, width): one combined row per kept tile
            part = padded[b + _outer_trim(out, call, n_outs, out.n_kept)]
            if reduce_fn is not None:
                part = lane_reduce(reduce_fn, torch.movedim(part, -1, 0),
                                   out.reduce_init)
            kept_exact = all(
                out.outer_lo[d] == 0 and out.outer_hi[d] == 0
                for d in range(out.n_kept))
            if kept_exact:
                return part
            kept = len(lead) + out.n_kept
            shape = lead + tuple(n_outs[:out.n_kept]) \
                + tuple(part.shape[kept:])
            seat = b + _outer_seat(out, n_outs, out.n_kept) \
                + (slice(None),) * (part.ndim - kept)
            return _seated(shape, seat, part)
        row = padded[b + (0,)]
        if reduce_fn is not None:
            return lane_reduce(reduce_fn, torch.movedim(row, -1, 0),
                               out.reduce_init)
        return row
    t0 = out.j_lo - (call.x_lo + out.lead)
    nrows = nj + out.j_hi - out.j_lo
    otrim = b + _outer_trim(out, call, n_outs, n_out)
    if out.kind == "acc_rows":
        # one identity-padded partial-accumulator row per grid step:
        # trim, fold the lanes, seat at the goal origin
        part = padded[otrim + (slice(t0, t0 + nrows), slice(None))]
        if lanes:
            return part
        vals = lane_reduce(reduce_fn, torch.movedim(part, -1, 0),
                           out.reduce_init)
        return _seated(lead + (*n_outs, nj),
                       b + _outer_seat(out, n_outs, n_out)
                       + (slice(out.j_lo, nj + out.j_hi),), vals)
    if out.kind == "external":
        jlo, jhi = out.j_lo, nj + out.j_hi
        return _seated(lead + (*n_outs, nj, ni),
                       b + _outer_seat(out, n_outs, n_out)
                       + (slice(jlo, jhi), slice(None)),
                       padded[otrim + (slice(t0, t0 + nrows), slice(None))])
    w = ni + out.i_hi - out.i_lo
    return padded[otrim + (slice(t0, t0 + nrows),
                           slice(out.i_lo, out.i_lo + w))]


def execute_plan(kplan: KernelPlan, *, interpreter: str = "cuda",
                 dtype=torch.float32, device=None, batched: bool = False,
                 **options):
    """Build the host callable executing a full :class:`KernelPlan` on
    the named registered interpreter.

    The returned function takes the program's external arrays (tensors
    or numpy arrays) as keyword arguments, moves them to ``device``
    (see :func:`resolve_device`) in ``dtype``, and returns
    ``{store name: tensor}`` for every goal.  It resolves runtime dim
    sizes through the plan's axiom shape contracts, runs each
    :class:`CallPlan` (host prologue, the interpreter's ``build_call``,
    output assembly, host epilogue) in order, and threads intermediate
    tensors through the environment.  The capability check runs here,
    so a plan outside the interpreter's declared feature set or dtypes
    raises :class:`PlanUnsupported` before anything builds.
    ``options`` are forwarded to ``build_call``, which runs once per
    call and problem size (its callable is kept for later calls).  On an
    interpreter that ``seats`` its outputs, the build is asked for them
    at their seat, and an output :func:`seatable` admits enters the
    environment as the kernel wrote it; every other ``external`` output
    is filled and copied by :func:`assemble` and counted in the counter
    ``plan.reseated`` (:mod:`repro_torch.obs`).

    ``batched=True`` builds the host half of a batch: every external
    array carries one leading batch axis, or is the sequence of its
    examples' tensors (one shape, ``dtype`` and ``device``, each
    contiguous, else ``ValueError``); sizes come from the first example's
    shape.
    The host half runs once over the batch -- the arrays' moves, the lane
    passes, the host steps (0-dim bodies, so elementwise over the
    examples) and the output assembly -- with one call of each
    :class:`CallPlan`'s ``build_batched`` callable, and returns every
    goal with the leading axis, each example's bits those of the
    unbatched host half on it.  A sequence goes to the calls that read
    it as it is, so the kernel reads each example where it lies; only
    where the host half itself reads the array (a lane pass, a host
    step, a scalar input, a goal) is it stacked, once.  Raises
    ``ValueError`` for an interpreter that declares no
    ``build_batched``."""
    spec = get_interpreter(interpreter)
    check_capabilities(spec, kplan, dtype)
    if batched and spec.build_batched is None:
        raise ValueError(f"interpreter {spec.name!r} declares no batched "
                         f"build_call")
    build = spec.build_batched if batched else spec.build_call
    seat = {"seated": True} if spec.seats else {}
    unknown = set(options) - spec.flags
    if unknown:
        raise TypeError(f"interpreter {spec.name!r} takes no build "
                        f"option(s) {sorted(unknown)}")
    device = resolve_device(device)
    dim_sym = dict(kplan.dim_sizes)
    inner = kplan.loop_order[-1]
    jdim = kplan.loop_order[-2]
    outer_dims = kplan.loop_order[:-2]
    input_names = sorted({ax.array for ax in kplan.axioms})
    # the arrays the host half reads itself: a batch given as its
    # examples' tensors is stacked for them
    host_reads = ({p.array for p in kplan.pre_passes + kplan.post_passes}
                  | {n for cp in kplan.calls
                     for hs in cp.host_pre + cp.host_post for n in hs.reads}
                  | {i.name for cp in kplan.calls for i in cp.inputs
                     if i.scalar}
                  | {var for _, var in kplan.goal_outputs})
    # each call's build_call runs once per problem size
    built: dict[tuple, object] = {}

    def fn(**arrays):
        with obs.span("plan.run"):
            return run(arrays)

    def run(arrays):
        sizes: dict[str, int] = {}
        for ax in kplan.axioms:
            shape = arrays[ax.array][0].shape if batched \
                else arrays[ax.array].shape
            ext = {d: (sym, lo, hi) for d, sym, lo, hi in ax.extents}
            for axis, d in enumerate(ax.dims):
                e = ext.get(d)
                if e is not None and e[0] not in sizes:
                    sizes[e[0]] = shape[axis] - (e[2] - e[1])
        nj = sizes[dim_sym[jdim]]
        ni = sizes[dim_sym[inner]]
        n_outs = tuple(sizes[dim_sym[d]] for d in outer_dims)
        with obs.span("plan.inputs"):
            env: dict = {}
            for name in input_names:
                arr = arrays[name]
                if batched and isinstance(arr, (list, tuple)):
                    arr = _examples(name, arr, dtype, device)
                    env[name] = torch.stack(arr) if name in host_reads \
                        else arr
                else:
                    env[name] = as_tensor(arr, dtype, device)
            for p in kplan.pre_passes:
                env[p.array] = _lane_permute(env[p.array], p)
        batch = (len(arrays[input_names[0]]),) if batched else ()
        for ci, cp in enumerate(kplan.calls):
            for hs in cp.host_pre:
                with obs.span("plan.host"):
                    _run_host(cp, hs, env)
            if cp.has_grid:
                key = (ci, n_outs, nj, ni)
                if key not in built:
                    built[key] = build(cp, (*n_outs, nj, ni), dtype,
                                       device=device, **seat,
                                       **options)[0]
                pcall = built[key]
                with obs.span("plan.inputs"):
                    args = []
                    for ispec in cp.inputs:
                        v = env[ispec.name]
                        if not isinstance(v, tuple):
                            v = as_tensor(v, dtype, device)
                        if ispec.scalar:
                            v = v.reshape(batch + (1, 1))
                        args.append(v)
                padded = pcall(*args)
                if not isinstance(padded, (list, tuple)):
                    padded = [padded]
                with obs.span("plan.reseat"):
                    for out, pout in zip(cp.outputs, padded):
                        if seat and seatable(cp, out):
                            env[out.name] = pout
                            continue
                        if out.kind == "external":
                            obs.count("plan.reseated")
                        env[out.name] = assemble(cp, out, pout, nj, ni,
                                                 n_outs, batched=batched)
            for hs in cp.host_post:
                with obs.span("plan.host"):
                    _run_host(cp, hs, env)
        if kplan.post_passes:
            with obs.span("plan.inputs"):
                for p in kplan.post_passes:
                    env[p.array] = _lane_permute(env[p.array], p,
                                                 inverse=True)
        return {store: env[var] for store, var in kplan.goal_outputs}

    return fn
