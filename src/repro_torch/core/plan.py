"""The KernelPlan IR: the declarative seam between analysis and execution.

The port's copy of ``repro.core.plan``: the same dataclasses, schema
and validate pass, so plans built by either package serialize to the
same JSON apart from where the kernel bodies live.  Two edits: the
row-kept init wrapper builds its identity row through
:func:`repro_torch.core.elementwise.full_like` (so a wrapped combine
also lowers to C), and :func:`from_reference_dict` re-points a plan
serialized by the JAX package at the port's kernel bodies.

HFAV's separation of concerns — *what* a loop nest must compute
(dependences, access patterns; Sections 3.2-3.4 of the paper) versus
*how* storage and iteration are laid out (fusion, contraction,
vectorization; Section 3.5) — is realized here as an explicit,
serializable intermediate representation.  The Pallas **planner**
(:func:`repro_torch.core.planner.plan_pallas`) lowers a storage plan to
a :class:`KernelPlan`; the Pallas **interpreter**
(:func:`repro_torch.core.interpreters.execute_plan`) runs one without
ever consulting the analysis pipeline.  The two sides share *only* this
module, so each is testable in isolation (golden-plan snapshots on the
planner, hand-built plans on the interpreter) and the engine can key its
compile cache on plan structure (:meth:`KernelPlan.cache_key`).

Everything in the IR is a frozen dataclass of plain values.  Kernel
callables are deliberately **outside** structural identity: each
:class:`CallPlan` carries its function table in a ``compare=False``
field, and steps reference it by index — two plans built from rebuilt
lambdas compare (and hash) equal, while :meth:`KernelPlan.cache_key`
folds the callables back in structurally via :func:`fn_key`.

All row widths are stored as deltas against the vector-dim size ``Ni``
(and row counts against ``Nj``, outer-tile counts against ``N_d``) so
one plan serves every problem size.

This module also owns every ``raise PallasUnsupported`` site: the
``require_*`` functions are the **validate pass**, invoked by the
planner while lowering and re-run by :meth:`KernelPlan.validate` on the
finished IR.  Each raise site carries a ``# doc-row:`` marker tying it
to the restriction table in docs/BACKENDS.md (enforced by
``scripts/check_docs.sh``).

The IR is **durable**: every dataclass has a versioned
``to_dict``/``from_dict`` pair (:data:`SCHEMA_VERSION`), and the kernel
callables — the one non-declarative ingredient — serialize as *function
specs* re-linked on load through the registered step-builder table
(:func:`register_step_builder`, :func:`fn_to_spec`,
:func:`fn_from_spec`): module-level functions travel as importable
references, reduction init-wrappers (:func:`acc_init_wrap`) as a
``with_init`` spec over their base, and anything else (lambdas,
closures) must be registered under a stable key or serialization raises
:class:`PlanSerializationError`.  The on-disk AOT cache
(:mod:`repro.core.plancache`) and the golden-plan corpus
(``tests/goldens/plans/``) are built on this format.
"""
from __future__ import annotations

import dataclasses
import importlib
import json
from dataclasses import dataclass, field
from typing import Callable, Optional, Union

from .elementwise import full_like

#: Version of the serialized-plan schema.  Bump on any change to the
#: dataclass fields, the function-spec format, or their meaning — the
#: on-disk plan cache treats entries from other versions as misses and
#: the golden corpus must be regenerated (scripts/warm_cache.py).
#: v2: ``ReadPlan.i_stride`` and the advisory ``KernelPlan.layout_hints``
#: section (:class:`LayoutHint`, written by ``repro_torch.core.vecscan``).
#: v3: the layout-transformation constructs written by
#: ``repro.core.layoutapply`` — carried-vector slots
#: (:class:`VecLoadPlan`, ``CallPlan.vloads``), physical left padding
#: (``InputPlan.align_pad``/``WindowPlan.align_pad``), blocked
#: accumulator lanes (``OutputPlan.lane_block``), host-side lane-dim
#: layout passes (:class:`LanePass`, ``KernelPlan.pre_passes``/
#: ``post_passes``) and the ``KernelPlan.applied_layout`` record.
SCHEMA_VERSION = 3


class PallasUnsupported(Exception):
    """A program shape the stencil executor does not cover.

    ``backend="auto"`` treats this as a routing signal and falls back to
    the JAX backend; ``backend="pallas"`` propagates it.  Messages name
    the specific restriction and the offending variable or dimension —
    the live restriction table is docs/BACKENDS.md, and every raise site
    lives in this module (the planner's validate pass)."""


def fn_key(fn):
    """Structural identity for a kernel callable.

    Keyed on ``(module, qualname, code object, closure cells, defaults)``
    so structurally identical programs whose kernels are *rebuilt*
    lambdas (fresh function objects compiled from the same source, e.g.
    a program-builder called twice) still hit the compile cache.
    Falls back to the function object itself when there is no code
    object (builtins/partials) or the closure/defaults are unhashable —
    identity is always correct, just cache-colder."""
    if fn is None:
        return None
    code = getattr(fn, "__code__", None)
    if code is None:
        return fn
    try:
        cells = tuple(c.cell_contents for c in
                      (getattr(fn, "__closure__", None) or ()))
        # bound methods share module/qualname/code/closure across
        # instances — the receiver must be part of the key, as must
        # keyword-only defaults (they don't appear in __defaults__)
        kwdefs = tuple(sorted((getattr(fn, "__kwdefaults__", None)
                               or {}).items()))
        extras = (getattr(fn, "__self__", None), cells,
                  getattr(fn, "__defaults__", None) or (), kwdefs)
        hash(extras)
    except (TypeError, ValueError):
        return fn
    return (fn.__module__, fn.__qualname__, code, extras)


# ---------------------------------------------------------------------------
# Plan serialization: function specs and the step-builder registry
# ---------------------------------------------------------------------------

class PlanSerializationError(Exception):
    """A plan cannot be serialized or deserialized.

    Raised when a kernel callable has no stable spec (a lambda/closure
    that was never registered via :func:`register_step_builder`), when a
    spec cannot be re-linked on load, or when a serialized plan's schema
    version does not match :data:`SCHEMA_VERSION`."""


_STEP_BUILDERS: dict[str, Callable] = {}


def register_step_builder(key: str, fn: Callable) -> None:
    """Register a kernel callable under a stable key.

    Serialized plans reference callables by spec; lambdas and closures
    have no importable identity, so programs built from them must
    register each callable here (same key in every process) before
    their plans can round-trip.  Re-registering a key overwrites it."""
    _STEP_BUILDERS[key] = fn


def unregister_step_builder(key: str) -> None:
    """Remove a registered step builder (no-op if absent)."""
    _STEP_BUILDERS.pop(key, None)


def acc_init_wrap(fn: Callable, init: float) -> Callable:
    """Wrap a reduction combine so its identity row is baked in:
    ``wrapped(*ins) == fn(full_like(ins[0], init), *ins)``.

    The planner uses this for row-kept reductions (each grid step's
    combine starts from the identity).  The wrapper carries its base
    callable and init value as attributes, so :func:`fn_to_spec`
    serializes it as a ``with_init`` spec over the base function."""
    def wrapped(*ins, _f=fn, _i=init):
        return _f(full_like(ins[0], _i), *ins)
    wrapped._plan_base_fn = fn
    wrapped._plan_init = float(init)
    return wrapped


def _resolve_ref(module: str, qualname: str):
    obj = importlib.import_module(module)
    for part in qualname.split("."):
        obj = getattr(obj, part)
    return obj


def fn_to_spec(fn: Callable) -> dict:
    """Serialize one kernel callable to a JSON-safe spec.

    Three spec kinds, tried in order: ``registered`` (the callable was
    registered via :func:`register_step_builder`), ``with_init`` (an
    :func:`acc_init_wrap` wrapper — recurses into its base), and ``ref``
    (an importable module-level function, stored as module + qualname).
    Anything else raises :class:`PlanSerializationError` — the plan is
    not durable until its callables have stable identities."""
    for key, cand in _STEP_BUILDERS.items():
        if cand is fn:
            return {"kind": "registered", "key": key}
    base = getattr(fn, "_plan_base_fn", None)
    if base is not None:
        return {"kind": "with_init", "base": fn_to_spec(base),
                "init": float(fn._plan_init)}
    mod = getattr(fn, "__module__", None)
    qn = getattr(fn, "__qualname__", None)
    if mod and qn and "<" not in qn:
        try:
            target = _resolve_ref(mod, qn)
        except Exception:
            target = None
        if target is fn:
            return {"kind": "ref", "module": mod, "qualname": qn}
    raise PlanSerializationError(
        f"kernel callable {fn!r} has no stable identity: not a "
        f"module-level function and not registered via "
        f"register_step_builder")


def fn_from_spec(spec: dict) -> Callable:
    """Re-link one serialized function spec to a live callable.

    The inverse of :func:`fn_to_spec`; raises
    :class:`PlanSerializationError` when a ``registered`` key is absent
    from the step-builder table or a ``ref`` no longer resolves."""
    kind = spec.get("kind")
    if kind == "registered":
        key = spec["key"]
        if key not in _STEP_BUILDERS:
            raise PlanSerializationError(
                f"step builder {key!r} is not registered in this process "
                f"(register_step_builder must run before plan loads)")
        return _STEP_BUILDERS[key]
    if kind == "with_init":
        return acc_init_wrap(fn_from_spec(spec["base"]),
                             float(spec["init"]))
    if kind == "ref":
        try:
            fn = _resolve_ref(spec["module"], spec["qualname"])
        except Exception as e:
            raise PlanSerializationError(
                f"cannot re-link {spec['module']}.{spec['qualname']}: {e}"
            ) from e
        if not callable(fn):
            raise PlanSerializationError(
                f"{spec['module']}.{spec['qualname']} resolved to a "
                f"non-callable {fn!r}")
        return fn
    raise PlanSerializationError(f"unknown function spec kind {kind!r}")


#: Module holding the reference's kernel bodies, and its port.
REFERENCE_PROGRAMS = "repro.core.programs"
PORT_PROGRAMS = "repro_torch.core.programs"


def _repoint_spec(spec: dict) -> dict:
    """One fn spec with every ``ref`` into the reference's program
    module re-pointed at the port's (recursing through ``with_init``)."""
    if spec.get("kind") == "with_init":
        return {**spec, "base": _repoint_spec(spec["base"])}
    if spec.get("kind") == "ref" and spec.get("module") == REFERENCE_PROGRAMS:
        return {**spec, "module": PORT_PROGRAMS}
    return spec


def from_reference_dict(d: dict, *, validate: bool = True) -> "KernelPlan":
    """The port :class:`KernelPlan` (validated unless ``validate`` is
    false) for a dict written by the JAX package's
    ``KernelPlan.to_dict()`` (or a golden JSON file): every ``ref`` fn
    spec naming ``repro.core.programs`` is re-pointed at
    ``repro_torch.core.programs`` before the fn tables re-link.  A dict
    of the port's own passes through unchanged."""
    d = dict(d)
    d["calls"] = [{**c, "fns": [_repoint_spec(f) for f in c["fns"]]}
                  for c in d["calls"]]
    kplan = KernelPlan.from_dict(d)
    return kplan.validate() if validate else kplan


def _jsonable(obj):
    """Generic dataclass walker producing JSON-native values; per-call
    fn tables serialize through fn_to_spec."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        out = {}
        for f in dataclasses.fields(obj):
            if f.name == "fns":
                out["fns"] = [fn_to_spec(fn) for fn in obj.fns]
            else:
                out[f.name] = _jsonable(getattr(obj, f.name))
        return out
    if isinstance(obj, (tuple, list)):
        return [_jsonable(x) for x in obj]
    return obj


def _pairs(rows, conv=str) -> tuple:
    return tuple((str(a), conv(b)) for a, b in rows)


# ---------------------------------------------------------------------------
# IR dataclasses
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class GridDim:
    """One Pallas grid dimension covering the canonical range
    ``[lo, N_dim + hi_off)`` — non-zero bounds when goals/axioms narrow
    the dim or plane windows prepend warm-up tiles.  The last grid dim
    of a :class:`CallPlan` is always the row dim."""

    dim: str
    lo: int = 0
    hi_off: int = 0

    def to_dict(self) -> dict:
        """JSON-native form (schema :data:`SCHEMA_VERSION`)."""
        return _jsonable(self)

    @classmethod
    def from_dict(cls, d: dict) -> "GridDim":
        """Rebuild from :meth:`to_dict` output."""
        return cls(str(d["dim"]), int(d["lo"]), int(d["hi_off"]))


@dataclass(frozen=True)
class AxiomPlan:
    """Shape contract of one external input array: its dims (outermost
    first) and per-dim ``(dim, size_symbol, lo, hi)`` extents — array
    length along a dim is ``size + hi - lo``.  The interpreter resolves
    concrete dim sizes from the runtime array shapes through these."""

    array: str
    dims: tuple[str, ...]
    extents: tuple[tuple[str, str, int, int], ...]

    def to_dict(self) -> dict:
        """JSON-native form (schema :data:`SCHEMA_VERSION`)."""
        return _jsonable(self)

    @classmethod
    def from_dict(cls, d: dict) -> "AxiomPlan":
        """Rebuild from :meth:`to_dict` output."""
        return cls(str(d["array"]), tuple(str(x) for x in d["dims"]),
                   tuple((str(a), str(b), int(c), int(e))
                         for a, b, c, e in d["extents"]))


@dataclass(frozen=True)
class InputPlan:
    """One streamed input of a stencil call.

    Array inputs cover positions ``[j_lo, Nj + j_hi) x [i_lo, Ni + i_hi)``
    of the iteration space (array index = position - origin) and stream
    one row per grid step into a ``stages``-row VMEM window at ``lead``
    rows ahead of the canonical point.  ``n_outer`` is the number of
    *outer* grid dimensions the array itself carries (fewer than the
    grid's broadcasts over the leading outer dims);
    ``outer_los``/``outer_his`` are its per-outer-dim origins.  Scalar
    inputs are 0-dim values passed as a single ``(1, 1)`` block.

    ``p_stages > 1`` (or a non-zero ``p_lead``) switches the input to
    *plane-window* mode: VMEM holds a ``(p_stages, rows, width)`` window
    of whole planes rotated across outer tiles of the plane dim (the
    grid's last outer dim), the streamed row landing in the newest plane
    ``p_lead`` tiles ahead, while older planes stay resident for
    ``u[k-1]``-style reads.

    ``align_pad`` left-pads the resident window physically: the
    streamed row lands at column ``align_pad`` instead of 0 and every
    read's physical origin shifts by the same amount, so the layout
    pass (:mod:`repro.core.layoutapply`, ``realign_origin``) can gift a
    row group a lane-aligned anchor load without changing what is
    read."""

    name: str
    stages: int = 1
    lead: int = 0
    j_lo: int = 0
    j_hi: int = 0  # array rows = Nj + (j_hi - j_lo)
    i_lo: int = 0
    i_hi: int = 0  # array cols = Ni + (i_hi - i_lo)
    scalar: bool = False
    n_outer: int = 0  # outer grid dims carried by the array itself
    p_stages: int = 1  # planes kept resident
    p_lead: int = 0  # plane-dim stream lead (tiles ahead)
    outer_los: tuple[int, ...] = ()  # per-outer-dim array origins
    outer_his: tuple[int, ...] = ()
    align_pad: int = 0  # physical left pad of the resident window

    @property
    def plane(self) -> bool:
        """Whether this input streams through a multi-plane VMEM window."""
        return self.p_stages > 1 or self.p_lead != 0

    def to_dict(self) -> dict:
        """JSON-native form (schema :data:`SCHEMA_VERSION`)."""
        return _jsonable(self)

    @classmethod
    def from_dict(cls, d: dict) -> "InputPlan":
        """Rebuild from :meth:`to_dict` output."""
        return cls(str(d["name"]), int(d["stages"]), int(d["lead"]),
                   int(d["j_lo"]), int(d["j_hi"]), int(d["i_lo"]),
                   int(d["i_hi"]), bool(d["scalar"]), int(d["n_outer"]),
                   int(d["p_stages"]), int(d["p_lead"]),
                   tuple(int(x) for x in d["outer_los"]),
                   tuple(int(x) for x in d["outer_his"]),
                   int(d.get("align_pad", 0)))


@dataclass(frozen=True)
class WindowPlan:
    """One VMEM window for a variable *produced inside* the stencil call.

    Rolling mode (``p_stages == 1``): ``stages`` rows covering column
    positions ``[i_lo, Ni + i_hi)``, rotated by mod-``stages`` row
    arithmetic (Fig. 9a/9b) — serves cross-row (j-offset) reads.

    Plane mode (``p_stages > 1`` or ``p_lead != 0``): whole planes of
    ``Nj + j_hi - j_lo`` rows stay resident across outer tiles of the
    plane dim; the producer runs ``p_lead`` tiles ahead and writes into
    the newest plane slot (mod-``p_stages``), rows addressed absolutely
    — serves same-nest ``v[k-1][j][i]``-style reads (the *producer
    plane window*, the outer-dim analogue of the rolling row window).

    ``align_pad`` left-pads the window physically (writes land at
    column ``align_pad`` plus their logical origin, reads shift the
    same way) so the layout pass can align a hot row group — see
    :class:`InputPlan`."""

    name: str
    stages: int
    i_lo: int = 0
    i_hi: int = 0
    p_stages: int = 1
    p_lead: int = 0  # producer's plane-dim software-pipeline lead
    j_lo: int = 0
    j_hi: int = 0  # plane rows = Nj + (j_hi - j_lo) (plane mode only)
    align_pad: int = 0  # physical left pad of the resident window

    @property
    def plane(self) -> bool:
        """Whether this window keeps whole planes resident."""
        return self.p_stages > 1 or self.p_lead != 0

    def to_dict(self) -> dict:
        """JSON-native form (schema :data:`SCHEMA_VERSION`)."""
        return _jsonable(self)

    @classmethod
    def from_dict(cls, d: dict) -> "WindowPlan":
        """Rebuild from :meth:`to_dict` output."""
        return cls(str(d["name"]), int(d["stages"]), int(d["i_lo"]),
                   int(d["i_hi"]), int(d["p_stages"]), int(d["p_lead"]),
                   int(d["j_lo"]), int(d["j_hi"]),
                   int(d.get("align_pad", 0)))


@dataclass(frozen=True)
class AccPlan:
    """One carried accumulator row (vector partial accumulator of a
    fused reduction): width ``Ni + w_off``, initialized to ``init``.

    ``n_kept`` counts the *leading* outer grid dims the reduction output
    keeps: 0 carries one running row across the entire grid (the k-tiled
    form); >= 1 re-initializes the row at the first step of every
    kept-prefix tile and emits one combined row per tile."""

    name: str
    w_off: int
    init: float
    n_kept: int = 0

    @property
    def per_outer(self) -> bool:
        """Whether the row re-initializes per kept-prefix outer tile."""
        return self.n_kept > 0

    def to_dict(self) -> dict:
        """JSON-native form (schema :data:`SCHEMA_VERSION`)."""
        return _jsonable(self)

    @classmethod
    def from_dict(cls, d: dict) -> "AccPlan":
        """Rebuild from :meth:`to_dict` output."""
        return cls(str(d["name"]), int(d["w_off"]), float(d["init"]),
                   int(d["n_kept"]))


@dataclass(frozen=True)
class ReadPlan:
    """One operand read of a fused step.

    ``src`` resolves against the call's namespace: ``in_<name>`` (a
    streamed input's window), ``b_<name>`` (a produced VMEM window),
    ``local:<name>`` (a same-grid-step row), or ``scalar:<name>``.
    ``j_off`` is the total row offset (consumer lead + stencil offset),
    ``p_off`` the total plane position (consumer plane lead + stencil
    offset) for plane-window sources; the read covers columns
    ``[col0, col0 + Ni + w_off)`` in iteration-space positions.

    ``i_stride`` is the lane-dim element stride (every ``i_stride``-th
    column).  The planner only emits unit-stride reads today; the field
    makes down-sampling stencils *expressible* in the IR — no built-in
    interpreter declares the ``strided_reads`` capability yet, so a
    non-unit stride is a typed refusal
    (:class:`~repro_torch.core.interpreters.PlanUnsupported` / PC008), never
    a miscompile, and ``repro_torch.core.vecscan`` classifies such sites as
    ``strided``."""

    src: str
    j_off: int
    col0: int
    w_off: int
    p_off: int = 0
    i_stride: int = 1

    def to_dict(self) -> dict:
        """JSON-native form (schema :data:`SCHEMA_VERSION`)."""
        return _jsonable(self)

    @classmethod
    def from_dict(cls, d: dict) -> "ReadPlan":
        """Rebuild from :meth:`to_dict` output."""
        return cls(str(d["src"]), int(d["j_off"]), int(d["col0"]),
                   int(d["w_off"]), int(d["p_off"]),
                   int(d.get("i_stride", 1)))


@dataclass(frozen=True)
class VecLoadPlan:
    """One carried-vector slot: a single per-grid-step load whose value
    is retained and reused across adjacent outputs (the in-register
    shuffle-reuse construct of arxiv 2103.08825, realized by the
    ``shift_reuse`` rewrite in :mod:`repro.core.layoutapply`).

    Each grid step loads columns ``[col0, col0 + Ni + w_off)`` of row
    ``j_off`` (plane ``p_off``) of the streamed source ``src``
    (``in_<name>`` form) into slot 0 of a ``(carry + 1)``-deep vector
    stack named ``name``; older slots hold the loads of the previous
    ``carry`` grid steps.  A step read with ``src == "vec:<name>"``
    resolves against this stack instead of the source window: the slot
    is ``j_off - read.j_off`` (static — the value loaded that many
    steps ago is exactly the row that many positions behind) and the
    column sub-span is the read's ``[col0, col0 + Ni + w_off)``
    re-based against the vload's ``col0``.  The rewrite is bit-exact:
    every ``vec:`` read returns the same elements the original
    window read produced, with one load per step instead of one per
    read."""

    name: str
    src: str
    j_off: int
    p_off: int
    col0: int
    w_off: int
    carry: int

    def to_dict(self) -> dict:
        """JSON-native form (schema :data:`SCHEMA_VERSION`)."""
        return _jsonable(self)

    @classmethod
    def from_dict(cls, d: dict) -> "VecLoadPlan":
        """Rebuild from :meth:`to_dict` output."""
        return cls(str(d["name"]), str(d["src"]), int(d["j_off"]),
                   int(d["p_off"]), int(d["col0"]), int(d["w_off"]),
                   int(d["carry"]))


@dataclass(frozen=True)
class StepPlan:
    """One fused kernel at its software-pipeline lead.

    ``op`` names the kernel rule (rendering/serialization); ``fn_idx``
    indexes the owning :class:`CallPlan`'s function table.  ``writes``
    holds one tuple of targets per produced value; each target is
    ``('buf', name) | ('local', name) | ('out', index)`` — a value may
    go to several targets.  The produced row covers columns
    ``[out_col0, out_col0 + Ni + out_w_off)``.

    Reduction steps set ``acc``: the named accumulator row is prepended
    to the kernel arguments and the combined result stored back,
    predicated on the canonical row position lying inside ``valid`` =
    ``(lo, hi_off)`` and every outer-dim position inside the matching
    ``valid_outer`` entry (warm-up/drain tiles must not pollute)."""

    op: str
    fn_idx: int
    reads: tuple[ReadPlan, ...]
    writes: tuple[tuple[tuple[str, Union[str, int]], ...], ...]
    lead: int
    out_col0: int = 0
    out_w_off: int = 0
    acc: Optional[str] = None
    valid: tuple[int, int] = (0, 0)
    valid_outer: tuple[tuple[int, int], ...] = ()

    def to_dict(self) -> dict:
        """JSON-native form (schema :data:`SCHEMA_VERSION`)."""
        return _jsonable(self)

    @classmethod
    def from_dict(cls, d: dict) -> "StepPlan":
        """Rebuild from :meth:`to_dict` output (``'out'`` write targets
        come back as ints, every other target kind as a name)."""
        writes = tuple(
            tuple((str(k), int(t) if k == "out" else str(t))
                  for k, t in targets)
            for targets in d["writes"])
        return cls(str(d["op"]), int(d["fn_idx"]),
                   tuple(ReadPlan.from_dict(r) for r in d["reads"]),
                   writes, int(d["lead"]), int(d["out_col0"]),
                   int(d["out_w_off"]),
                   None if d["acc"] is None else str(d["acc"]),
                   (int(d["valid"][0]), int(d["valid"][1])),
                   tuple((int(a), int(b)) for a, b in d["valid_outer"]))


@dataclass(frozen=True)
class OutputPlan:
    """One stencil-call output and its host-side trim/seat rule.

    ``kind`` selects the assembly: ``'external'`` (a goal array row
    stream re-seated at its goal origin), ``'full'`` (a halo'd
    materialized intermediate kept in its own origin frame), ``'acc'``
    (a carried/kept-prefix accumulator block, lane-reduced via
    ``reduce_idx`` when the vector dim was folded) or ``'acc_rows'``
    (row-kept reductions: one identity-padded partial row per grid
    step, lane-reduced on the host).  ``outer_lo``/``outer_hi`` give the
    bound variable's canonical extent ``[lo, N_d + hi)`` per outer grid
    dim; ``outer_lead`` the producing step's per-outer-dim pipeline lead
    (a plane-window producer running tiles ahead writes its output that
    many blocks early); ``fill`` pads device rows outside the computed
    span (the combine identity for ``acc_rows``).

    ``lane_block`` (``acc_rows`` outputs only) asks the interpreter to
    pre-fold each grid step's identity-padded partial row into
    ``lane_block``-wide chunks on the device before emitting it, so the
    host's cross-lane fold runs over ``lane_block`` elements per row
    instead of the full padded width — the ``acc_lane_block`` rewrite
    of :mod:`repro.core.layoutapply`.  Pre-folding reassociates the
    reduction, so the pass only sets it under ``mode="force"``."""

    name: str
    kind: str  # 'external' | 'full' | 'acc' | 'acc_rows'
    lead: int = 0
    j_lo: int = 0
    j_hi: int = 0
    i_lo: int = 0
    i_hi: int = 0
    outer_lo: tuple[int, ...] = ()
    outer_hi: tuple[int, ...] = ()
    outer_lead: tuple[int, ...] = ()
    acc: Optional[str] = None
    fill: float = 0.0
    n_kept: int = 0
    reduce_idx: Optional[int] = None  # lane reduction, into CallPlan.fns
    reduce_init: float = 0.0
    lane_block: int = 0  # device pre-fold width for acc_rows (0 = off)

    def to_dict(self) -> dict:
        """JSON-native form (schema :data:`SCHEMA_VERSION`)."""
        return _jsonable(self)

    @classmethod
    def from_dict(cls, d: dict) -> "OutputPlan":
        """Rebuild from :meth:`to_dict` output."""
        return cls(str(d["name"]), str(d["kind"]), int(d["lead"]),
                   int(d["j_lo"]), int(d["j_hi"]), int(d["i_lo"]),
                   int(d["i_hi"]),
                   tuple(int(x) for x in d["outer_lo"]),
                   tuple(int(x) for x in d["outer_hi"]),
                   tuple(int(x) for x in d["outer_lead"]),
                   None if d["acc"] is None else str(d["acc"]),
                   float(d["fill"]), int(d["n_kept"]),
                   None if d["reduce_idx"] is None else int(d["reduce_idx"]),
                   float(d["reduce_init"]),
                   int(d.get("lane_block", 0)))


@dataclass(frozen=True)
class HostStepPlan:
    """A 0-dim kernel executed on the host before/after a stencil call,
    reading and writing named environment entries."""

    op: str
    fn_idx: int
    reads: tuple[str, ...]
    writes: tuple[str, ...]

    def to_dict(self) -> dict:
        """JSON-native form (schema :data:`SCHEMA_VERSION`)."""
        return _jsonable(self)

    @classmethod
    def from_dict(cls, d: dict) -> "HostStepPlan":
        """Rebuild from :meth:`to_dict` output."""
        return cls(str(d["op"]), int(d["fn_idx"]),
                   tuple(str(x) for x in d["reads"]),
                   tuple(str(x) for x in d["writes"]))


@dataclass(frozen=True)
class LanePass:
    """One host-side lane-dim data-layout pass (the DLT transformation
    of arxiv 2103.09235, emitted by the ``layout_transform`` rewrite in
    :mod:`repro.core.layoutapply`).

    A pre-pass de-interleaves the named environment ``array`` along its
    last (lane) dimension: old column ``c`` moves to
    ``(c % stride) * (width // stride) + c // stride``, turning every
    ``stride``-strided read into a unit-stride read of the transformed
    layout.  A post-pass applies the inverse permutation to re-seat an
    output.  ``width`` is the *concrete* lane extent the rewrite was
    specialized for — the executor asserts the runtime array matches it
    (layout transforms are size-specialized; a mismatched size is a
    hard error, never a silent miscompile)."""

    array: str
    stride: int
    width: int

    def to_dict(self) -> dict:
        """JSON-native form (schema :data:`SCHEMA_VERSION`)."""
        return _jsonable(self)

    @classmethod
    def from_dict(cls, d: dict) -> "LanePass":
        """Rebuild from :meth:`to_dict` output."""
        return cls(str(d["array"]), int(d["stride"]), int(d["width"]))


@dataclass(frozen=True)
class CallPlan:
    """One top-level fused nest: host prologue steps, at most one
    stencil call (``grid`` empty for host-only nests), host epilogue
    steps.  ``grid`` lists outer dims first and the row dim last; the
    vector dim is folded across lanes.  ``vloads`` holds the call's
    carried-vector slots (:class:`VecLoadPlan`) that ``vec:<name>``
    step reads resolve against.  ``fns`` is the call's kernel
    function table — excluded from structural equality (steps reference
    it by index; :meth:`KernelPlan.cache_key` re-keys it via
    :func:`fn_key`)."""

    name: str
    grid: tuple[GridDim, ...]
    vec_dim: str
    inputs: tuple[InputPlan, ...] = ()
    windows: tuple[WindowPlan, ...] = ()
    accs: tuple[AccPlan, ...] = ()
    steps: tuple[StepPlan, ...] = ()
    outputs: tuple[OutputPlan, ...] = ()
    host_pre: tuple[HostStepPlan, ...] = ()
    host_post: tuple[HostStepPlan, ...] = ()
    vloads: tuple[VecLoadPlan, ...] = ()
    fns: tuple[Callable, ...] = field(default=(), compare=False, repr=False)

    @property
    def has_grid(self) -> bool:
        """Whether this nest lowers to a stencil call at all."""
        return bool(self.grid)

    @property
    def n_outer(self) -> int:
        """Grid dims ahead of the row dim."""
        return len(self.grid) - 1

    @property
    def row_dim(self) -> str:
        """The grid's final (fastest) dimension identifier."""
        return self.grid[-1].dim

    @property
    def x_lo(self) -> int:
        """Canonical row-loop start (negative = pipeline priming rows)."""
        return self.grid[-1].lo

    @property
    def x_hi_off(self) -> int:
        """Row-loop end offset: rows cover ``[x_lo, Nj + x_hi_off)``."""
        return self.grid[-1].hi_off

    @property
    def outer_lo(self) -> tuple[int, ...]:
        """Per-outer-dim canonical range starts."""
        return tuple(g.lo for g in self.grid[:-1])

    @property
    def outer_hi_off(self) -> tuple[int, ...]:
        """Per-outer-dim canonical range end offsets."""
        return tuple(g.hi_off for g in self.grid[:-1])

    def to_dict(self) -> dict:
        """JSON-native form (schema :data:`SCHEMA_VERSION`); the fn
        table serializes as function specs (:func:`fn_to_spec`)."""
        return _jsonable(self)

    @classmethod
    def from_dict(cls, d: dict) -> "CallPlan":
        """Rebuild from :meth:`to_dict` output, re-linking the fn table
        through :func:`fn_from_spec` (raises
        :class:`PlanSerializationError` when a spec cannot resolve)."""
        return cls(
            name=str(d["name"]),
            grid=tuple(GridDim.from_dict(g) for g in d["grid"]),
            vec_dim=str(d["vec_dim"]),
            inputs=tuple(InputPlan.from_dict(i) for i in d["inputs"]),
            windows=tuple(WindowPlan.from_dict(w) for w in d["windows"]),
            accs=tuple(AccPlan.from_dict(a) for a in d["accs"]),
            steps=tuple(StepPlan.from_dict(s) for s in d["steps"]),
            outputs=tuple(OutputPlan.from_dict(o) for o in d["outputs"]),
            host_pre=tuple(HostStepPlan.from_dict(h) for h in d["host_pre"]),
            host_post=tuple(HostStepPlan.from_dict(h)
                            for h in d["host_post"]),
            vloads=tuple(VecLoadPlan.from_dict(v)
                         for v in d.get("vloads", ())),
            fns=tuple(fn_from_spec(s) for s in d.get("fns", ())),
        )


@dataclass(frozen=True)
class LayoutHint:
    """One advisory layout transformation recommended by the static
    vectorization analyzer (:mod:`repro_torch.core.vecscan`).

    Hints are **advisory**: interpreters that don't understand them
    execute the plan unchanged (the
    :class:`~repro_torch.core.interpreters.InterpreterSpec.layout_aware` flag
    says whether a ``build_call`` consults them), they are excluded
    from structural plan equality and the compile-cache key, and they
    round-trip through plan serialization so a layout pass can
    consume them from serialized plans.  ``kind`` names the transformation
    (``shift_reuse`` — replace overlapping shifted loads of one
    resident row with one widened load plus in-register shifts;
    ``realign_origin`` — re-origin a window so a row group gains an
    aligned anchor load; ``layout_transform`` — a lane-dim data-layout
    transform for gather/strided access; ``acc_lane_block`` — block a
    row-kept accumulator over lanes to avoid the per-row cross-lane
    fold), ``call`` the owning nest, ``target`` the source / output it
    applies to, ``params`` sorted ``(key, value)`` pairs quantifying
    the opportunity, and ``note`` the human-readable rationale."""

    kind: str
    call: str
    target: str
    params: tuple = ()
    note: str = ""

    def to_dict(self) -> dict:
        """JSON-native form (schema :data:`SCHEMA_VERSION`)."""
        return _jsonable(self)

    @classmethod
    def from_dict(cls, d: dict) -> "LayoutHint":
        """Rebuild from :meth:`to_dict` output (numeric param values
        keep their JSON type; JSON arrays come back as tuples)."""
        def untuple(v):
            return tuple(untuple(x) for x in v) \
                if isinstance(v, (list, tuple)) else v
        return cls(str(d["kind"]), str(d["call"]), str(d["target"]),
                   tuple((str(k), untuple(v)) for k, v in d["params"]),
                   str(d["note"]))


#: The feature-tag universe for per-interpreter capability validation
#: (:meth:`KernelPlan.features` computes a plan's subset; an
#: :class:`~repro_torch.core.interpreters.InterpreterSpec` declares the
#: subset it can execute).  A tag names one execution mechanism a plan
#: may demand of its interpreter; a plan whose feature set is not
#: contained in an interpreter's capability set raises
#: :class:`~repro_torch.core.interpreters.PlanUnsupported` instead of
#: miscompiling.  Keep this in sync with ``KernelPlan.features`` and
#: the capability table in docs/ARCHITECTURE.md.
PLAN_FEATURES = frozenset({
    "multi_call",               # > 1 stencil call (split schedule)
    "host_steps",               # host prologue/epilogue steps
    "scalar_inputs",            # (1, 1) scalar operands
    "outer_grid",               # leading outer grid dims (n_outer >= 1)
    "rolling_input_windows",    # streamed inputs with > 1 resident row
    "plane_window_inputs",      # streamed multi-plane windows (u[k-1])
    "rolling_windows",          # produced-var rolling row windows
    "producer_plane_windows",   # produced-var plane windows
    "acc_carried",              # whole-grid carried accumulators
    "acc_kept_prefix",          # accumulators re-init per kept tile
    "acc_rows",                 # row-kept partial-accumulator outputs
    "lane_reduce",              # host-side lane fold of folded accs
    "local_rows",               # same-step local row values
    "strided_reads",            # non-unit lane-dim read strides
    "vec_loads",                # carried-vector slots (vec: reads)
    "align_pad",                # physically left-padded windows
    "lane_block",               # device pre-fold of acc_rows lanes
})


@dataclass(frozen=True)
class KernelPlan:
    """A complete, declarative execution plan for one program on the
    stencil executor: the planner's output, the interpreter's input.

    ``dim_sizes`` maps every loop identifier to its runtime size symbol;
    ``goal_outputs`` pairs each goal's store name with the environment
    variable holding it after the final call.  ``layout_hints`` is the
    advisory :class:`LayoutHint` section written by the vectorization
    analyzer (:mod:`repro_torch.core.vecscan`) — like the per-call fn tables
    it is excluded from structural equality (and therefore from
    :meth:`cache_key`), but unlike them it serializes by value and
    survives the on-disk plan cache.

    ``pre_passes``/``post_passes`` are host-side :class:`LanePass`
    layout changes run around the device calls, and ``applied_layout``
    records which hint rewrites the layout pass
    (:mod:`repro.core.layoutapply`) realized as
    ``(kind, call, target)`` triples.  All three participate in
    structural equality — a transformed plan never shares a
    :meth:`cache_key` with its untransformed original."""

    program: str
    loop_order: tuple[str, ...]
    dim_sizes: tuple[tuple[str, str], ...]
    axioms: tuple[AxiomPlan, ...]
    goal_outputs: tuple[tuple[str, str], ...]
    calls: tuple[CallPlan, ...]
    layout_hints: tuple = field(default=(), compare=False)
    pre_passes: tuple[LanePass, ...] = ()
    post_passes: tuple[LanePass, ...] = ()
    applied_layout: tuple[tuple[str, str, str], ...] = ()

    def features(self) -> frozenset:
        """The subset of :data:`PLAN_FEATURES` this plan demands of an
        interpreter — the plan side of the per-interpreter capability
        check (:func:`repro_torch.core.interpreters.check_capabilities`)."""
        tags = set()
        if len([c for c in self.calls if c.has_grid]) > 1:
            tags.add("multi_call")
        for c in self.calls:
            if c.host_pre or c.host_post:
                tags.add("host_steps")
            if any(i.scalar for i in c.inputs):
                tags.add("scalar_inputs")
            if not c.has_grid:
                continue
            if c.n_outer:
                tags.add("outer_grid")
            for i in c.inputs:
                if i.scalar:
                    continue
                if i.plane:
                    tags.add("plane_window_inputs")
                elif i.stages > 1:
                    tags.add("rolling_input_windows")
            for w in c.windows:
                tags.add("producer_plane_windows" if w.plane
                         else "rolling_windows")
            for a in c.accs:
                tags.add("acc_kept_prefix" if a.n_kept else "acc_carried")
            for o in c.outputs:
                if o.kind == "acc_rows":
                    tags.add("acc_rows")
                if o.reduce_idx is not None:
                    tags.add("lane_reduce")
            if any(kind == "local" for s in c.steps
                   for targets in s.writes for kind, _ in targets):
                tags.add("local_rows")
            if any(rd.i_stride != 1 for s in c.steps for rd in s.reads):
                tags.add("strided_reads")
            if c.vloads:
                tags.add("vec_loads")
            if any(i.align_pad for i in c.inputs if not i.scalar) or \
                    any(w.align_pad for w in c.windows):
                tags.add("align_pad")
            if any(o.lane_block for o in c.outputs):
                tags.add("lane_block")
        return frozenset(tags)

    def validate(self) -> "KernelPlan":
        """Re-run the restriction checks expressible over the finished
        IR (the planner already ran the context-dependent ones while
        lowering).  Raises :class:`PallasUnsupported` for restriction
        violations and ``ValueError`` for structurally malformed plans;
        returns ``self`` so the planner can ``return plan.validate()``."""
        require_loop_order(self.loop_order)
        jdim, inner = self.loop_order[-2], self.loop_order[-1]
        for call in self.calls:
            if not call.has_grid:
                continue
            if call.row_dim != jdim or call.vec_dim != inner:
                raise ValueError(
                    f"call {call.name}: grid row/vector dims "
                    f"({call.row_dim!r}, {call.vec_dim!r}) disagree with "
                    f"the loop order {self.loop_order}")
            names = {f"in_{i.name}" for i in call.inputs if not i.scalar}
            names |= {f"scalar:{i.name}" for i in call.inputs if i.scalar}
            names |= {w.name for w in call.windows}
            for i in call.inputs:
                if not i.scalar and i.align_pad < 0:
                    raise ValueError(
                        f"call {call.name}: input {i.name} has negative "
                        f"align_pad {i.align_pad}")
            for w in call.windows:
                if w.align_pad < 0:
                    raise ValueError(
                        f"call {call.name}: window {w.name} has negative "
                        f"align_pad {w.align_pad}")
            ins_by_src = {f"in_{i.name}": i for i in call.inputs
                          if not i.scalar}
            vloads = {f"vec:{v.name}": v for v in call.vloads}
            for v in call.vloads:
                ispec = ins_by_src.get(v.src)
                if ispec is None:
                    raise ValueError(
                        f"call {call.name}: vload {v.name} reads "
                        f"{v.src!r}, which is not a streamed input")
                if v.carry < 0:
                    raise ValueError(
                        f"call {call.name}: vload {v.name} has negative "
                        f"carry {v.carry}")
                if v.col0 < ispec.i_lo or v.col0 + v.w_off > ispec.i_hi:
                    raise ValueError(
                        f"call {call.name}: vload {v.name} spans "
                        f"[{v.col0}, Ni{v.w_off:+d}) outside the resident "
                        f"window [{ispec.i_lo}, Ni{ispec.i_hi:+d}) of "
                        f"{v.src}")
                if v.p_off and not ispec.plane:
                    require_plane_window_read(v.src, v.p_off)
            names |= set(vloads)
            accs = {a.name for a in call.accs}
            for a in call.accs:
                require_kept_prefix_len(a.name, a.n_kept, call.n_outer)
            locals_: set[str] = set()
            for s in call.steps:
                for targets in s.writes:
                    for kind, tgt in targets:
                        if kind == "local":
                            locals_.add(f"local:{tgt}")
            plane_srcs = {f"in_{i.name}" for i in call.inputs if i.plane}
            plane_srcs |= {w.name for w in call.windows if w.plane}
            for s in call.steps:
                if s.acc is not None and s.acc not in accs:
                    raise ValueError(
                        f"call {call.name}: step {s.op} names unknown "
                        f"accumulator {s.acc!r}")
                for rd in s.reads:
                    if rd.src not in names and rd.src not in locals_:
                        raise ValueError(
                            f"call {call.name}: step {s.op} reads "
                            f"unresolved source {rd.src!r}")
                    vl = vloads.get(rd.src)
                    if vl is not None:
                        slot = vl.j_off - rd.j_off
                        if rd.p_off != vl.p_off:
                            raise ValueError(
                                f"call {call.name}: step {s.op} reads "
                                f"{rd.src} at plane {rd.p_off:+d} but the "
                                f"vload carries plane {vl.p_off:+d}")
                        if not (0 <= slot <= vl.carry):
                            raise ValueError(
                                f"call {call.name}: step {s.op} reads "
                                f"{rd.src} at row {rd.j_off:+d}, "
                                f"{slot} step(s) behind the vload's "
                                f"{vl.j_off:+d} — outside its carry depth "
                                f"{vl.carry}")
                        if rd.col0 < vl.col0 or \
                                rd.col0 + rd.w_off > vl.col0 + vl.w_off:
                            raise ValueError(
                                f"call {call.name}: step {s.op} reads "
                                f"{rd.src} cols [{rd.col0}, "
                                f"Ni{rd.w_off:+d}) outside the vload span "
                                f"[{vl.col0}, Ni{vl.w_off:+d})")
                    if rd.p_off and rd.src not in plane_srcs \
                            and vl is None:
                        require_plane_window_read(rd.src, rd.p_off)
                    if rd.i_stride < 1:
                        raise ValueError(
                            f"call {call.name}: step {s.op} reads "
                            f"{rd.src} with non-positive lane stride "
                            f"{rd.i_stride}")
                for targets in s.writes:
                    for kind, tgt in targets:
                        if kind == "out" and not (
                                0 <= int(tgt) < len(call.outputs)):
                            raise ValueError(
                                f"call {call.name}: step {s.op} writes "
                                f"out-of-range output {tgt}")
                if s.valid_outer and len(s.valid_outer) != call.n_outer:
                    raise ValueError(
                        f"call {call.name}: step {s.op} valid_outer rank "
                        f"{len(s.valid_outer)} != n_outer {call.n_outer}")
            for out in call.outputs:
                if out.kind in ("external", "full", "acc_rows"):
                    require_output_row_span(out.name, out.i_lo, out.i_hi)
                if out.lane_block < 0:
                    raise ValueError(
                        f"call {call.name}: output {out.name} has "
                        f"negative lane_block {out.lane_block}")
                if out.lane_block and (out.kind != "acc_rows"
                                       or out.reduce_idx is None):
                    raise ValueError(
                        f"call {call.name}: output {out.name} sets "
                        f"lane_block but is not a lane-reduced acc_rows "
                        f"output")
                if out.acc is not None and out.acc not in accs:
                    raise ValueError(
                        f"call {call.name}: output {out.name} names "
                        f"unknown accumulator {out.acc!r}")
        return self

    def render(self) -> str:
        """Human-readable plan dump (``explain(..., verbose=True)``)."""
        lines = [f"kernel plan: {self.program}",
                 f"  loop order: ({', '.join(self.loop_order)})"]
        for call in self.calls:
            if not call.has_grid:
                lines.append(f"  call {call.name}: host-only")
            else:
                gd = " x ".join(
                    f"{g.dim}=[{g.lo}, N{g.dim}{g.hi_off:+d})"
                    for g in call.grid)
                lines.append(f"  call {call.name}: grid {gd}")
            for hs in call.host_pre:
                lines.append(f"    host pre  {hs.op}: "
                             f"{', '.join(hs.reads)} -> "
                             f"{', '.join(hs.writes)}")
            for i in call.inputs:
                if i.scalar:
                    lines.append(f"    input {i.name}: scalar")
                    continue
                desc = (f"    input {i.name}: rows[{i.j_lo},{i.j_hi:+d}] "
                        f"cols[{i.i_lo},{i.i_hi:+d}] lead={i.lead} "
                        f"stages={i.stages}")
                if i.plane:
                    desc += (f" plane_window={i.p_stages}"
                             f" p_lead={i.p_lead}")
                if i.align_pad:
                    desc += f" align_pad={i.align_pad}"
                lines.append(desc)
            for w in call.windows:
                if w.plane:
                    lines.append(
                        f"    window {w.name}: {w.p_stages} planes "
                        f"p_lead={w.p_lead} rows[{w.j_lo},{w.j_hi:+d}] "
                        f"cols[{w.i_lo},{w.i_hi:+d}]")
                else:
                    lines.append(
                        f"    window {w.name}: {w.stages} rows "
                        f"cols[{w.i_lo},{w.i_hi:+d}]"
                        + (f" align_pad={w.align_pad}"
                           if w.align_pad else ""))
            for a in call.accs:
                lines.append(f"    acc {a.name}: width Ni{a.w_off:+d} "
                             f"init={a.init} n_kept={a.n_kept}")
            for v in call.vloads:
                lines.append(
                    f"    vload {v.name}: {v.src}"
                    f"[{('p%+d ' % v.p_off) if v.p_off else ''}"
                    f"j{v.j_off:+d}] cols[{v.col0},Ni{v.w_off:+d}] "
                    f"carry={v.carry}")
            for s in call.steps:
                rd = ", ".join(
                    f"{r.src}[{('p%+d ' % r.p_off) if r.p_off else ''}"
                    f"j{r.j_off:+d}"
                    f"{(':%d' % r.i_stride) if r.i_stride != 1 else ''}]"
                    for r in s.reads)
                wr = "; ".join(
                    ",".join(f"{k}:{t}" for k, t in targets)
                    for targets in s.writes) or (f"acc:{s.acc}")
                lines.append(f"    step {s.op} @lead {s.lead}: "
                             f"reads [{rd}] -> {wr}")
            for o in call.outputs:
                lines.append(
                    f"    out {o.name}: {o.kind} lead={o.lead} "
                    f"rows[{o.j_lo},{o.j_hi:+d}]"
                    + (f" outer_lead={o.outer_lead}"
                       if any(o.outer_lead) else "")
                    + (f" lane_block={o.lane_block}"
                       if o.lane_block else ""))
            for hs in call.host_post:
                lines.append(f"    host post {hs.op}: "
                             f"{', '.join(hs.reads)} -> "
                             f"{', '.join(hs.writes)}")
        for p in self.pre_passes:
            lines.append(f"  pre-pass {p.array}: de-interleave stride "
                         f"{p.stride} @ width {p.width}")
        for p in self.post_passes:
            lines.append(f"  post-pass {p.array}: re-interleave stride "
                         f"{p.stride} @ width {p.width}")
        if self.applied_layout:
            lines.append("  applied layout: " + ", ".join(
                f"{kind}({call}:{tgt})"
                for kind, call, tgt in self.applied_layout))
        lines.append("  goals: " + ", ".join(
            f"{store}<-{var}" for store, var in self.goal_outputs))
        return "\n".join(lines)

    def to_dict(self) -> dict:
        """Full durable form: every field in JSON-native values, the
        per-call fn tables as re-linkable function specs, and the
        schema version stamped in (the on-disk plan cache's payload and
        the golden-corpus file format)."""
        d = _jsonable(self)
        d["schema"] = SCHEMA_VERSION
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "KernelPlan":
        """Rebuild a plan from :meth:`to_dict` output.

        Checks the schema version first (mismatch raises
        :class:`PlanSerializationError` — stale cache entries must
        re-plan, not misexecute) and re-links every kernel callable
        through the function-spec table.  The result is structurally
        equal to the original plan and shares its
        :meth:`cache_key`; callers holding untrusted bytes should
        re-run :meth:`validate` (the on-disk cache does)."""
        ver = d.get("schema")
        if ver != SCHEMA_VERSION:
            raise PlanSerializationError(
                f"serialized plan has schema version {ver!r}; this "
                f"build reads version {SCHEMA_VERSION}")
        return cls(
            program=str(d["program"]),
            loop_order=tuple(str(x) for x in d["loop_order"]),
            dim_sizes=_pairs(d["dim_sizes"]),
            axioms=tuple(AxiomPlan.from_dict(a) for a in d["axioms"]),
            goal_outputs=_pairs(d["goal_outputs"]),
            calls=tuple(CallPlan.from_dict(c) for c in d["calls"]),
            layout_hints=tuple(LayoutHint.from_dict(h)
                               for h in d.get("layout_hints", ())),
            pre_passes=tuple(LanePass.from_dict(p)
                             for p in d.get("pre_passes", ())),
            post_passes=tuple(LanePass.from_dict(p)
                              for p in d.get("post_passes", ())),
            applied_layout=tuple(
                (str(k), str(c), str(t))
                for k, c, t in d.get("applied_layout", ())),
        )

    def to_json(self) -> str:
        """Serialize the plan (function tables rendered as op names —
        the IR is declarative; callables travel separately)."""
        def strip(obj):
            if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
                d = {}
                for f in dataclasses.fields(obj):
                    if f.name == "fns":
                        continue
                    d[f.name] = strip(getattr(obj, f.name))
                return d
            if isinstance(obj, (list, tuple)):
                return [strip(x) for x in obj]
            return obj
        return json.dumps(strip(self), indent=1, sort_keys=True)

    def cache_key(self):
        """Hashable identity for compiled-executor caching: the plan's
        structural equality plus the kernel callables keyed by
        :func:`fn_key` — plans that differ structurally, or whose
        kernels differ behaviorally, get distinct entries."""
        return (self, tuple(tuple(fn_key(f) for f in c.fns)
                            for c in self.calls))


# ---------------------------------------------------------------------------
# The validate pass: every PallasUnsupported raise site lives below.
# The planner invokes these while lowering (context-dependent checks);
# KernelPlan.validate() re-runs the IR-expressible subset.
# ---------------------------------------------------------------------------

def require_loop_order(loop_order: tuple[str, ...]) -> None:
    """The executor needs at least a (row, vector) identifier pair."""
    if len(loop_order) < 2:
        # doc-row: loop order shorter than
        raise PallasUnsupported(
            f"loop order {loop_order} has {len(loop_order)} dim(s): the "
            f"stencil executor needs at least a (row, vector) pair")


def require_host_group_0dim(group: str, dims: tuple[str, ...]) -> None:
    """Host-side groups must be 0-dim kernels."""
    if dims:
        # doc-row: host kernels between stencil calls
        raise PallasUnsupported(
            f"host-side group {group} iterates {dims}: only 0-dim "
            f"kernels can run between stencil calls")


def require_host_read_no_offset(group: str, var: str) -> None:
    """Host-side kernels read their operands at offset zero."""
    # doc-row: host kernels between stencil calls
    raise PallasUnsupported(
        f"group {group} reads {var} at a non-zero offset: 0-dim host "
        f"kernels cannot read offsets")


def require_host_orderable(group: str, jdim: str) -> None:
    """Host steps must order entirely before or after the grid."""
    # doc-row: host kernels between stencil calls
    raise PallasUnsupported(
        f"group {group} cannot be ordered around the {jdim}-grid")


def require_nest_outputs(nest_idx: int) -> None:
    """Every grid nest must produce at least one output."""
    # doc-row: host kernels between stencil calls
    raise PallasUnsupported(f"nest {nest_idx} produces no outputs")


def require_offset_in_window_dims(var: str, dim: str, off: int,
                                  pdim: Optional[str], jdim: str,
                                  inner: str) -> None:
    """Stencil offsets live in the innermost three dims: row, vector,
    and the plane dim (served by plane windows)."""
    # doc-row: stencil offsets beyond the plane dim
    raise PallasUnsupported(
        f"read of {var} at offset {off:+d} in outer dim {dim!r}: "
        f"stencil offsets are only supported in the innermost three "
        f"dims ({pdim!r}, {jdim!r}, {inner!r})")


def require_no_nonplane_lead(group: str, dim: str, lead: int) -> None:
    """Only the plane dim supports software-pipeline leads across outer
    tiles (a producer plane window); leads in any other outer dim would
    need volume windows."""
    # doc-row: stencil offsets beyond the plane dim
    raise PallasUnsupported(
        f"group {group} runs {lead} tile(s) ahead in outer dim {dim!r}: "
        f"producers may only run ahead in the plane dim (plane windows); "
        f"offsets beyond the plane dim need volume windows")


def require_plane_window_read(src: str, p_off: int) -> None:
    """A plane-offset read must resolve to a plane-window source."""
    # doc-row: stencil offsets beyond the plane dim
    raise PallasUnsupported(
        f"plane-offset read (p{p_off:+d}) of {src}: the source has no "
        f"plane window")


def require_streamed_suffix(name: str, dims: tuple[str, ...],
                            loop_order: tuple[str, ...]) -> None:
    """Streamed arrays span a >= 2-D suffix of the loop order."""
    rank = len(dims)
    if rank < 2 or tuple(dims) != tuple(loop_order[-rank:]):
        # doc-row: streamed input dims not a suffix of the loop order
        raise PallasUnsupported(
            f"streamed input {name} spans dims {dims}: the executor "
            f"streams arrays whose dims are a suffix of the loop order "
            f"{loop_order} ending in ({loop_order[-2]!r}, "
            f"{loop_order[-1]!r}); 1-D row variables cannot cross a "
            f"stencil-call boundary")


def require_nest_order(name: str) -> None:
    """A nest may only stream variables produced by earlier nests."""
    # doc-row: streamed input dims not a suffix of the loop order
    raise PallasUnsupported(f"{name} consumed before its producing nest")


def require_materialized_extents(name: str) -> None:
    """Materialized intermediates need (j, i) extents to cross calls."""
    # doc-row: streamed input dims not a suffix of the loop order
    raise PallasUnsupported(f"materialized {name} lacks (j, i) extents")


def require_scalar_acc_stream(name: str, dims: tuple[str, ...]) -> None:
    """Only fully-reduced scalars stream between stencil calls."""
    # doc-row: cross-call read of a vector accumulator
    raise PallasUnsupported(
        f"cross-call read of vector accumulator {name} (dims {dims}): "
        f"only fully-reduced scalars stream between stencil calls")


def require_representable_read(name: str, kind: str) -> None:
    """Reads must resolve to a streamed window, VMEM window, or local."""
    # doc-row: cross-call read of a vector accumulator
    raise PallasUnsupported(
        f"read of {name}: storage kind {kind!r} is not representable "
        f"inside a stencil call")


def require_representable_write(name: str, kind: str) -> None:
    """Writes must target a window, local row, or call output."""
    # doc-row: cross-call read of a vector accumulator
    raise PallasUnsupported(
        f"write of {name}: storage kind {kind!r} is not representable "
        f"inside a stencil call")


def require_reduction_result_kind(name: str, kind: str) -> None:
    """Reduction results are accumulators or terminal outputs."""
    if kind not in ("acc", "external_out"):
        # doc-row: cross-call read of a vector accumulator
        raise PallasUnsupported(
            f"reduction result {name} of storage kind {kind!r}: only "
            f"accumulator or terminal results are supported")


def require_full_outer_iteration(group: str, missing: list[str],
                                 loop_order: tuple[str, ...]) -> None:
    """Every kernel fused into an outer grid iterates all of it."""
    # doc-row: kernels not iterating the full outer grid
    raise PallasUnsupported(
        f"group {group} lacks outer grid dim(s) {missing}: every kernel "
        f"fused into a {'/'.join(loop_order)} nest must iterate the "
        f"full outer grid")


def require_row_contraction(name: str, dim: Optional[str],
                            jdim: str) -> None:
    """Rolling buffers contract over the row dim only."""
    if dim != jdim:
        # doc-row: contraction over a non-row dim
        raise PallasUnsupported(
            f"rolling buffer {name} contracts over dim {dim!r}: the "
            f"executor only carries windows across the row dim {jdim!r}")


def require_reduction_iterates_vector(group: str) -> None:
    """Reductions must iterate the vector dim (lane accumulators)."""
    # doc-row: reductions not iterating the vector dim
    raise PallasUnsupported(
        f"reduction {group} does not iterate the vector dim")


def require_row_kept_vector_only(name: str, jdim: str,
                                 reduced: tuple[str, ...],
                                 inner: str) -> None:
    """Row-kept reductions may only fold the vector dim."""
    if set(reduced) != {inner}:
        # doc-row: row-kept reductions reducing an outer dim
        raise PallasUnsupported(
            f"reduction output {name} keeps the row dim {jdim!r} while "
            f"reducing {reduced}: row-kept reductions may only reduce "
            f"the vector dim {inner!r}")


def require_kept_prefix(name: str, kept_outer: tuple[str, ...],
                        outer_dims: tuple[str, ...]) -> None:
    """Kept outer dims of a reduction form a leading grid prefix."""
    if kept_outer != tuple(outer_dims[:len(kept_outer)]):
        # doc-row: reductions keeping a non-prefix outer subset
        raise PallasUnsupported(
            f"reduction output {name} keeps outer dims {kept_outer} of "
            f"a {outer_dims} grid: kept outer dims must form a leading "
            f"prefix of the grid (the accumulator re-initializes per "
            f"kept tile)")


def require_kept_prefix_len(name: str, n_kept: int, n_outer: int) -> None:
    """An accumulator cannot keep more outer dims than the grid has."""
    if n_kept > n_outer:
        # doc-row: reductions keeping a non-prefix outer subset
        raise PallasUnsupported(
            f"accumulator {name} keeps {n_kept} outer dim(s) of a "
            f"{n_outer}-outer grid")


def require_output_row_span(name: str, i_lo: int, i_hi: int,
                            what: str = "row") -> None:
    """Device output rows must sit inside the Ni-wide block."""
    if i_lo < 0 or i_hi > 0:
        # doc-row: negative innermost origins on outputs
        raise PallasUnsupported(
            f"{what} of {name} spans [{i_lo}, Ni{i_hi:+d}): outside the "
            f"Ni-wide output row")


def require_matching_producer_extent(name: str) -> None:
    """A materialized variable's producer must cover its full extent."""
    # doc-row: negative innermost origins on outputs
    raise PallasUnsupported(
        f"{name}: producer extent differs from variable extent; cannot "
        f"materialize across calls")


def require_same_step_position(name: str, kind: str, pos: int,
                               prod_pos: int) -> None:
    """Same-step (local) reads must match the producer's row position —
    row/scalar variables carry no window to bridge a lead mismatch."""
    if pos != prod_pos:
        # doc-row: lead-mismatched same-step reads
        raise PallasUnsupported(
            f"read of same-nest {kind} variable {name} at row position "
            f"{pos} but produced at {prod_pos}: variables without a "
            f"VMEM window cannot be read across rows")
