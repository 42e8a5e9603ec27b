"""Lower one :class:`~repro_torch.core.plan.CallPlan` to CUDA C++.

HFAV's own back end emits C per fused nest; this module does the same
per ``CallPlan``.  The device machinery shared by every plan — slots,
clamped rows, streaming, chunk ownership, the launcher — is hand
written in ``csrc/stencil2d.cuh``; the source emitted here holds only
the plan's step sequence and its kernel bodies, lowered to C by a
tracer:

* :class:`CVal` is a symbolic float with overloaded ``+ - * /``, unary
  ``-``, comparisons and boolean ``& | ~``; ``where``, ``sqrt`` and
  ``full_like`` reach it through :mod:`repro_torch.core.elementwise`.
  Each operation appends one SSA statement, so a body lowers in one
  pass to straight-line C.  Float literals carry an ``f`` suffix (so
  ``4.0 * c`` stays single precision) and anything the tracer cannot
  lower raises :class:`LoweringError` when the source is emitted, never
  at run time.
* :func:`row_phases` cuts a call's row step into phases: the fused
  steps of a phase run in one loop over the columns, and a barrier
  stands between two phases only where a step reads, or overwrites, a
  shared element that an earlier step of the phase wrote at another
  thread's column.  A local read only at its writer's column, in its
  writer's phase, lives in a register.
* :class:`CallLayout` fixes what a plan needs at run time: which outer
  dims go across blocks and which a block walks in order, how the row
  range splits into chunks and, in a call with plane windows, the plane
  dim into plane chunks (one block per pair: a plane chunk times a row
  tile), how far a block's walk starts before its first owned plane and
  row (the reach of the windows' reads behind their writes), where each
  window lives (a plane window holds only its block's row tile, in
  shared memory when the block's windows fit; an input window holds
  more rows or planes for the copies in flight: :meth:`CallLayout._ring`),
  and the order of the kernel's pointer and size parameters.
  :meth:`CallLayout.concretize` gives their values for one problem size,
  choosing the chunk lengths for the fewest row steps in waves of the
  blocks an SM holds of the built kernel.

Sizes are runtime parameters, so one source (and one build) serves
every problem size of a plan.  The element type is not: a call's source
is emitted for float32, bf16 or float16 (:data:`ELEMENTS`), its windows
and rows in that type, its arithmetic, locals and accumulators in float.
"""
from __future__ import annotations

import math
import re
from dataclasses import dataclass

from ...core.interpreters import PlanUnsupported, seatable
from ...core.plan import CallPlan, WindowPlan

#: Most threads a block runs, and the columns of a row each thread takes
#: (they stride over the row): enough that a row step's fixed work (the
#: ring's wait, barrier and copies, the slots) is shared by several.
MAX_THREADS = 1024
COLS_PER_THREAD = 4
#: Shared memory one block may use on Hopper (bytes).
SMEM_LIMIT = 232448
#: The SMs of an H100 (the default when the device is not known).
H100_SMS = 132
#: The element types the kernel stores, by torch dtype name: (C type,
#: bytes).
ELEMENTS = {"float32": ("float", 4), "bfloat16": ("__nv_bfloat16", 2),
            "float16": ("__half", 2)}
#: The conversions of a 2-byte element type: (to float, from float,
#: rounding to nearest even).
CONVERSIONS = {"bfloat16": ("__bfloat162float", "__float2bfloat16_rn"),
               "float16": ("__half2float", "__float2half_rn")}


def dtype_name(dtype) -> str:
    """The :data:`ELEMENTS` key of ``dtype`` (a torch dtype or its
    name); raises :class:`PlanUnsupported` for a type the kernel does
    not build for."""
    name = str(dtype).removeprefix("torch.")
    if name not in ELEMENTS:
        raise PlanUnsupported(
            f"the CUDA stencil kernel builds for "
            f"{', '.join(ELEMENTS)}, not {name}")
    return name


class LoweringError(PlanUnsupported):
    """A kernel body uses an operation the CUDA emitter cannot lower."""


# ---------------------------------------------------------------------------
# The tracer: kernel bodies to straight-line C
# ---------------------------------------------------------------------------

def c_float(v) -> str:
    """A Python number as a single-precision C literal."""
    if isinstance(v, bool):
        return "true" if v else "false"
    v = float(v)
    if math.isnan(v):
        return "__int_as_float(0x7fc00000)"
    if math.isinf(v):
        return "__int_as_float(0x7f800000)" if v > 0 \
            else "__int_as_float(0xff800000)"
    r = repr(v)
    if "e" not in r and "." not in r:
        r += ".0"
    return f"({r}f)" if v < 0 else f"{r}f"


class _Tracer:
    """Collects the SSA statements of one body."""

    def __init__(self):
        self.lines: list[str] = []

    def arg(self, v) -> str:
        if isinstance(v, CVal):
            if v.tracer is not self:
                raise LoweringError("a traced value escaped its body")
            return v.code
        if isinstance(v, (bool, int, float)):
            return c_float(v)
        raise LoweringError(
            f"cannot lower an operand of type {type(v).__name__} to C")

    def op(self, expr: str, kind: str = "f") -> "CVal":
        name = f"t{len(self.lines)}"
        ctype = "float" if kind == "f" else "bool"
        self.lines.append(f"  const {ctype} {name} = {expr};")
        return CVal(self, name, kind)


def _binary(sym: str, kind: str = "f", swap: bool = False):
    def method(self, other):
        tr = self.tracer
        a, b = (other, self) if swap else (self, other)
        return tr.op(f"({tr.arg(a)} {sym} {tr.arg(b)})", kind)
    return method


def _refuse(what: str):
    def method(self, *args):
        raise LoweringError(f"{what} has no lowering to C in a kernel body")
    return method


class CVal:
    """A symbolic scalar of a kernel body under the CUDA tracer."""

    __slots__ = ("tracer", "code", "kind")

    def __init__(self, tracer: _Tracer, code: str, kind: str = "f"):
        self.tracer = tracer
        self.code = code
        self.kind = kind

    __add__ = _binary("+")
    __radd__ = _binary("+", swap=True)
    __sub__ = _binary("-")
    __rsub__ = _binary("-", swap=True)
    __mul__ = _binary("*")
    __rmul__ = _binary("*", swap=True)
    __truediv__ = _binary("/")
    __rtruediv__ = _binary("/", swap=True)
    __lt__ = _binary("<", "b")
    __le__ = _binary("<=", "b")
    __gt__ = _binary(">", "b")
    __ge__ = _binary(">=", "b")
    __eq__ = _binary("==", "b")
    __ne__ = _binary("!=", "b")
    __and__ = _binary("&&", "b")
    __rand__ = _binary("&&", "b", swap=True)
    __or__ = _binary("||", "b")
    __ror__ = _binary("||", "b", swap=True)
    __hash__ = object.__hash__

    def __neg__(self):
        return self.tracer.op(f"(-{self.code})", self.kind)

    def __pos__(self):
        return self

    def __invert__(self):
        return self.tracer.op(f"(!{self.code})", "b")

    def __abs__(self):
        return self.tracer.op(f"fabsf({self.code})")

    __bool__ = _refuse("data-dependent control flow (use where())")
    __pow__ = _refuse("**")
    __rpow__ = _refuse("**")
    __floordiv__ = _refuse("//")
    __rfloordiv__ = _refuse("//")
    __mod__ = _refuse("%")
    __rmod__ = _refuse("%")
    __float__ = _refuse("float()")
    __int__ = _refuse("int()")
    __index__ = _refuse("indexing")

    @classmethod
    def lower_call(cls, name: str, *args):
        """The dispatch hook of :mod:`repro_torch.core.elementwise`."""
        tr = next(a.tracer for a in args if isinstance(a, CVal))
        if name == "where":
            cond, a, b = args
            return tr.op(f"({tr.arg(cond)} ? {tr.arg(a)} : {tr.arg(b)})")
        if name == "sqrt":
            return tr.op(f"sqrtf({tr.arg(args[0])})")
        if name == "full_like":
            return CVal(tr, c_float(args[1]))
        raise LoweringError(f"{name}() has no lowering to C")


def lower_body(fn, n_args: int, n_outs: int, name: str) -> str:
    """The ``__device__`` C function computing ``fn`` on one column:
    ``float name(a0..)`` for one output, ``void name(a0.., r0&..)`` for
    several.  Raises :class:`LoweringError` for anything the tracer
    cannot lower."""
    tr = _Tracer()
    args = [CVal(tr, f"a{k}") for k in range(n_args)]
    label = getattr(fn, "__qualname__", repr(fn))
    try:
        res = fn(*args)
    except LoweringError:
        raise
    except Exception as e:  # an operation outside the tracer's vocabulary
        raise LoweringError(
            f"kernel body {label} does not lower to C: "
            f"{type(e).__name__}: {e}") from e
    outs = tuple(res) if isinstance(res, (tuple, list)) else (res,)
    if len(outs) != n_outs:
        raise LoweringError(f"kernel body {label} returns {len(outs)} "
                            f"value(s); its step writes {n_outs}")
    vals = [tr.arg(v) for v in outs]
    params = ", ".join(f"const float a{k}" for k in range(n_args))
    lines = [f"// {label}"]
    if n_outs == 1:
        lines.append(f"static __device__ __forceinline__ float {name}("
                     f"{params}) {{")
        lines += tr.lines
        lines.append(f"  return {vals[0]};")
    else:
        outp = ", ".join(f"float& r{k}" for k in range(n_outs))
        lines.append(f"static __device__ __forceinline__ void {name}("
                     f"{params}{', ' if params else ''}{outp}) {{")
        lines += tr.lines
        lines += [f"  r{k} = {v};" for k, v in enumerate(vals)]
    lines.append("}")
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# The row step: phases, barriers and register locals
# ---------------------------------------------------------------------------

#: Row steps a block issues its input rows ahead of their use (cp.async),
#: at least and at most: a launch takes the fewest that keep
#: ``RING_BYTES`` of input rows in flight on an SM (its resident blocks
#: together; about the memory rate times its latency over 132 SMs).  A
#: rolling input window holds this many more rows, a plane input window
#: as many more planes as a step this far ahead can reach.
RING_MIN, RING_MAX = 2, 8
RING_BYTES = 48 * 1024
#: Partial accumulator rows the device fold takes in one group (the last
#: block of each group folds it, the last group folds the groups).
FOLD_GROUP = 16


def _touches(step):
    """The shared locations one step reads and writes in its row step, as
    ``(kind, name, plane, row, col)``: a local at the thread's column
    offset, a rolling buffer at a row, a plane window at a (plane, row).
    Input windows are written only by the ring, accumulators only at the
    thread's own column, outputs in device memory: none of them is a
    hazard inside a row step."""
    reads, writes = [], []
    for rd in step.reads:
        if rd.src.startswith("local:"):
            reads.append(("local", rd.src[6:], 0, 0, rd.col0))
        elif rd.src.startswith("b_"):
            reads.append(("buf", rd.src, rd.p_off, rd.j_off, rd.col0))
    if step.acc is None:
        for targets in step.writes:
            for kind, tgt in targets:
                if kind == "local":
                    writes.append(("local", str(tgt), 0, 0, 0))
                elif kind == "buf":
                    writes.append(("buf", str(tgt), None, step.lead,
                                   step.out_col0))
    return reads, writes


def _clash(write, other, plane_lead: dict) -> bool:
    """Whether ``other`` (a read or a write) may touch what ``write``
    wrote, at another thread's column.  A plane window's read at or above
    its write row may meet it where the rows clamp at the edge."""
    if write[:2] != other[:2] or write[4] == other[4]:
        return False
    if write[0] == "local":
        return True
    pl = plane_lead.get(write[1])
    if pl is None:  # a rolling buffer: one row each
        return write[3] == other[3]
    return (other[2] if other[2] is not None else pl) == pl \
        and other[3] <= write[3]


def row_phases(call: CallPlan):
    """``(phases, register_locals)`` of ``call``'s row step: the steps in
    phases (lists of step indices, in order), a barrier between two
    phases only where a step reads or overwrites what an earlier step of
    the phase wrote at another thread's column; and the locals that live
    in registers: read only at the writer's column, in the writer's
    phase."""
    plane_lead = {w.name: w.p_lead for w in call.windows if w.plane}
    phases: list[list[int]] = [[]]
    seen: list[tuple] = []  # (kind, touch) of the current phase
    phase_of = {}
    for si, step in enumerate(call.steps):
        reads, writes = _touches(step)
        mine = [("r", t) for t in reads] + [("w", t) for t in writes]
        if any(_clash(a, b, plane_lead)
               for k, t in seen for j, u in mine
               for a, b in (((t, u),) if k == "w" else ())
               + (((u, t),) if j == "w" else ())):
            phases.append([])
            seen = []
        phases[-1].append(si)
        seen += mine
        phase_of[si] = len(phases) - 1
    writer, readers = {}, {}
    for si, step in enumerate(call.steps):
        reads, writes = _touches(step)
        for t in writes:
            if t[0] == "local":
                writer[t[1]] = si
        for t in reads:
            if t[0] == "local":
                readers.setdefault(t[1], []).append((si, t[4]))
    regs = {name for name, w in writer.items()
            if all(col == 0 and phase_of[si] == phase_of[w]
                   for si, col in readers.get(name, []))}
    return phases, regs


# ---------------------------------------------------------------------------
# The runtime layout of one call
# ---------------------------------------------------------------------------

def _ident(name: str) -> str:
    return re.sub(r"[^0-9A-Za-z_]", "_", name)


def _round4(n: int) -> int:
    return -(-n // 4) * 4


def cap4(n: int, itemsize: int = 4) -> int:
    """Elements a ring window row of ``n`` values of ``itemsize`` bytes
    takes (``hfav::cap4``, ``hfav::cap8`` for 2 bytes): room to start at
    its source row's address mod 16 bytes."""
    per = 16 // itemsize
    return (n + 2 * per - 2) // per * per


@dataclass(frozen=True)
class Launch:
    """One call's concrete launch: the size parameters in kernel order,
    the grid, what the wrapper allocates, and the blocks an SM holds of
    the built kernel at this launch (``resident``) and the waves of them
    the grid takes, and the fold's tickets."""

    ints: tuple[int, ...]
    nblocks: int
    threads: int
    smem_bytes: int
    scratch_floats: int
    gsz: tuple[int, ...]
    steps_j: int
    nchunks: int
    ni: int
    sizes: tuple[int, ...]
    npchunks: int = 1
    chunk_len: int = 1
    pchunk_len: int = 1
    resident: int = 1
    waves: int = 1
    tickets: int = 1
    #: examples of a batched launch (``kernel.batch_launch``); 0 for a
    #: single call
    batch: int = 0
    #: the card's SMs the launch was sized for
    sms: int = H100_SMS
    #: row steps all blocks walk (owned and priming), and those they own
    rows_walked: int = 0
    rows_owned: int = 0


#: Global scratch the planner of a plane-window launch may ask for when
#: its windows do not fit shared memory (bytes).
MAX_GLOBAL_SCRATCH = 1 << 30


def _walked(n: int, length: int, prime: int) -> int:
    """Steps the chunks of ``length`` of a range of ``n`` walk in all,
    each from ``prime`` steps before its first owned one
    (``hfav::chunk_of``)."""
    return sum(min(own + length, n) - max(own - prime, 0)
               for own in range(0, n, length))


def _per_sm(resident):
    """``resident`` (blocks an SM holds: a count, or a function of the
    block's threads and shared-memory bytes) as a function."""
    if callable(resident):
        return resident
    return lambda threads, smem_bytes: int(resident)


class CallLayout:
    """What one :class:`CallPlan` needs at run time (see the module
    docstring).  With ``seated``, the kernel stores each output that
    :func:`~repro_torch.core.interpreters.seatable` admits at its seat in
    the goal array (``seated_outs``).  Raises :class:`PlanUnsupported`
    for calls outside the kernel's shape."""

    def __init__(self, call: CallPlan, dtype="float32", seated: bool = False):
        self.call = call
        #: the outputs stored at their seat, in the goal's shape
        self.seated_outs = [k for k, o in enumerate(call.outputs)
                            if seated and seatable(call, o)]
        #: the element type's :data:`ELEMENTS` key and bytes
        self.dtype = dtype_name(dtype)
        self.itemsize = ELEMENTS[self.dtype][1]
        n_out = call.n_outer
        self.arr_ins = [i for i in call.inputs if not i.scalar]
        self.row_ins = [i for i in self.arr_ins if not i.plane]
        self.plane_ins = [i for i in self.arr_ins if i.plane]
        self.roll_wins = [WindowPlan(f"in_{i.name}", i.stages, i.i_lo, i.i_hi)
                          for i in self.row_ins] \
            + [w for w in call.windows if not w.plane]
        self.ring_wins = {f"in_{i.name}" for i in self.row_ins}
        if any(not 0 <= i.lead < i.stages + RING_MIN for i in self.row_ins):
            raise PlanUnsupported(
                f"call {call.name}: an input streams behind its row step or "
                f"further ahead than its ring holds")
        self.plane_wins = [w for w in call.windows if w.plane]
        self.phases, self.reg_locals = row_phases(call)
        #: barriers a block meets in one row step: one after the ring's
        #: wait, one between two phases
        self.barriers_per_row = len(self.phases)
        self.local_w: dict[str, int] = {}
        self.acc_fold: dict[str, int] = {}
        for step in call.steps:
            if step.acc is not None:
                if len(step.reads) != 1:
                    raise PlanUnsupported(
                        f"call {call.name}: reduction step {step.op} reads "
                        f"{len(step.reads)} operands; folding per-block "
                        f"partial rows needs a binary combine")
                self.acc_fold[step.acc] = step.fn_idx
                continue
            for targets in step.writes:
                for kind, tgt in targets:
                    if kind == "local":
                        self.local_w.setdefault(str(tgt), step.out_w_off)
        # one per-block region (shared memory, or a global slice): rolling
        # rows, the locals not in registers, accumulators, then the plane
        # windows of a row tile
        self.planes = [("plane", i.name) for i in self.plane_ins] \
            + [("pwin", w.name) for w in self.plane_wins]
        #: each ring window's table of row shifts (ints): where a row
        #: starts past a 16-byte boundary, as its source row does
        self.shifts = [("shift", f"in_{i.name}") for i in self.row_ins] \
            + [("shift", i.name) for i in self.plane_ins]
        self.fast = [("win", w.name) for w in self.roll_wins] \
            + [("local", n) for n in self.local_w
               if n not in self.reg_locals] \
            + [("acc", a.name) for a in call.accs] + self.planes \
            + self.shifts
        self.planar = bool(self.planes)
        #: the plane dim, cut into plane chunks across blocks
        self.pdim = n_out - 1 if self.planar else None
        seq = set()
        if self.planar:
            seq.add(self.pdim)
        for a in call.accs:
            seq.update(range(a.n_kept, n_out))
        self.seq_dims = sorted(seq)
        #: outer dims a block walks whole, in order
        self.walk_dims = [d for d in self.seq_dims if d != self.pdim]
        self.indep_dims = [d for d in range(n_out) if d not in seq]
        # how far each plane window's reads reach behind its writes (rows,
        # planes), and the rows one tile touches
        self.span: dict[tuple[str, str], int] = {}
        #: the lowest row (relative to the row step's) a plane window
        #: holds: a tile's rows sit at their distance from it
        self.row_lo: dict[tuple[str, str], int] = {}
        back = pback = 0
        for key in self.planes:
            lead, p_lead, j_lo, src = self._plane_writer(key)
            reads = [r for s in call.steps for r in s.reads if r.src == src]
            if any(r.j_off > lead for r in reads):
                raise PlanUnsupported(
                    f"call {call.name}: plane window {key[1]} is read "
                    f"below the row it is written at; a row tile would "
                    f"have to walk past its last row")
            p_stages = self._plane_stages(key)
            if any(not p_lead - p_stages < r.p_off <= p_lead for r in reads):
                raise PlanUnsupported(
                    f"call {call.name}: plane window {key[1]} is read at a "
                    f"plane it does not hold")
            offs = [lead - j_lo] + [r.j_off - j_lo for r in reads]
            self.span[key] = max(offs) - min(offs)
            self.row_lo[key] = min(offs)
            back += max([0] + [lead - r.j_off for r in reads])
            pback += max([0] + [p_lead - r.p_off for r in reads])
        # row steps a chunk's block runs before its first owned row: the
        # longest chain of reads back through the rolling windows, and
        # every plane window's reads behind their writes; planes it runs
        # before its first owned plane
        self.prime = self._row_reach() + back
        self.pprime = pback
        #: the accumulator outputs, folded on the device
        self.acc_outs = [k for k, o in enumerate(call.outputs)
                         if o.acc is not None]
        self.int_names = (
            ["ni", "nj", "steps_j", "chunk_len", "nchunks", "pchunk_len",
             "npchunks", "nblocks", "use_smem", "fast_floats", "ring",
             "ring_planes", "fold_groups"]
            + [f"osz{d}" for d in range(n_out)]
            + [f"g{d}" for d in range(n_out)]
            + [f"off_f{m}" for m in range(len(self.fast))]
            + [f"prows{m}" for m in range(len(self.planes))]
            + [f"part{k}" for k in self.acc_outs]
            + [f"ptmp{k}" for k in self.acc_outs])
        # inputs, outputs, the global scratch, the fold's ticket
        self.n_ptrs = len(call.inputs) + len(call.outputs) + 2

    def _row_reach(self) -> int:
        """Row steps before a row step ``t`` that a block's walk must
        start for every step to compute at ``t`` what a walk from the
        range's start computes: the longest chain back through the
        reads.  A step at row step ``t`` reads a rolling row input's row
        ``t + j_off``, copied at ``t + j_off - lead``, and a rolling
        window's, written by its producer at ``t + j_off - lead``, which
        reaches back in turn; a local was written in the same row step.
        Plane windows pass their producer's reach on: their reads behind
        their writes are the ``back`` term."""
        steps = self.call.steps
        ins = {f"in_{i.name}": i.lead for i in self.row_ins}
        rolling = {w.name for w in self.roll_wins}
        writer: dict[str, int] = {}
        for si, step in enumerate(steps):
            if step.acc is None:
                for targets in step.writes:
                    for kind, tgt in targets:
                        if kind == "local":
                            writer[f"local:{tgt}"] = si
                        elif kind == "buf":
                            writer[str(tgt)] = si
        reach = [0] * len(steps)
        # the longest path to each step; a row-carried read of a later
        # step's window needs another pass, at most one a step
        for _ in range(len(steps) + 1):
            before = list(reach)
            for si, step in enumerate(steps):
                for rd in step.reads:
                    if rd.src in ins:
                        back = ins[rd.src] - rd.j_off
                    elif rd.src in writer:
                        p = writer[rd.src]
                        back = reach[p] + (steps[p].lead - rd.j_off
                                           if rd.src in rolling else 0)
                    else:  # a scalar, or a plane input: the ``back`` term
                        continue
                    reach[si] = max(reach[si], back)
            if reach == before:
                return max(reach, default=0)
        raise PlanUnsupported(
            f"call {self.call.name}: its steps' reads reach back without "
            f"end (a window read ahead of its write)")

    def _plane_writer(self, key):
        """``(row lead, plane lead, j_lo, read source)`` of a plane
        window: where its writes land relative to the canonical point."""
        kind, name = key
        if kind == "plane":
            i = next(i for i in self.plane_ins if i.name == name)
            return i.lead, i.p_lead, i.j_lo, f"in_{name}"
        w = next(w for w in self.plane_wins if w.name == name)
        lead = next(s.lead for s in self.call.steps for targets in s.writes
                    for k, t in targets if k == "buf" and str(t) == name)
        return lead, w.p_lead, w.j_lo, name

    def _plane_stages(self, key) -> int:
        kind, name = key
        return next(w.p_stages for w in self.plane_ins + self.plane_wins
                    if w.name == name)

    def _floats(self, kind: str, name: str, ni: int, rows: int, ring: int,
                ring_planes: int) -> int:
        """4-byte words of one item of the region: locals and
        accumulators hold floats, shift tables ints, windows elements."""
        if kind in ("shift", "local", "acc"):
            return self._elements(kind, name, ni, rows, ring, ring_planes)
        return -(-self._elements(kind, name, ni, rows, ring, ring_planes)
                 * self.itemsize // 4)

    def _elements(self, kind: str, name: str, ni: int, rows: int, ring: int,
                  ring_planes: int) -> int:
        if kind == "shift":
            if name in self.ring_wins:
                return next(i.stages for i in self.row_ins
                            if f"in_{i.name}" == name) + ring
            i = next(i for i in self.plane_ins if i.name == name)
            return (i.p_stages + ring_planes) * rows
        if kind == "win":
            w = next(w for w in self.roll_wins if w.name == name)
            if name in self.ring_wins:
                return (w.stages + ring) * cap4(ni + w.i_hi - w.i_lo,
                                                self.itemsize)
            return w.stages * (ni + w.i_hi - w.i_lo)
        if kind == "local":
            return ni + self.local_w[name]
        if kind == "acc":
            a = next(a for a in self.call.accs if a.name == name)
            return ni + a.w_off
        if kind == "plane":
            i = next(i for i in self.plane_ins if i.name == name)
            return (i.p_stages + ring_planes) * rows \
                * cap4(ni + i.i_hi - i.i_lo, self.itemsize)
        w = next(w for w in self.plane_wins if w.name == name)
        return w.p_stages * rows * (ni + w.i_hi - w.i_lo)

    def plane_reduced(self, acc) -> bool:
        """Whether ``acc`` sums over the plane dim, so each plane chunk
        leaves a partial row of its own."""
        return self.planar and self.pdim >= acc.n_kept

    def _ring(self, ni: int, steps_j: int, clen: int, walk: int,
              planes: int, threads: int, per_sm):
        """``(ring, ring_planes, region floats, resident)`` of a row
        chunk of ``clen`` (a block walking at most ``planes`` planes):
        the fewest row steps ahead (``RING_MIN`` .. ``RING_MAX``) whose
        copies, over the blocks an SM then holds, reach ``RING_BYTES``."""
        row = self.itemsize * sum(ni + i.i_hi - i.i_lo
                                  for i in self.arr_ins)
        for ring in range(RING_MIN, RING_MAX + 1):
            rp = self.ring_planes(steps_j, clen, ring, planes)
            fast = self._region(ni, walk, ring, rp)[0]
            smem = fast * 4 if fast * 4 <= SMEM_LIMIT else 0
            resident = per_sm(threads, smem)
            if resident * ring * row >= RING_BYTES or not row:
                break
        return ring, rp, fast, resident

    def ring_planes(self, steps_j: int, clen: int, ring: int,
                    planes: int) -> int:
        """Planes past a plane window's own that a ring copy can reach:
        ``ring`` row steps ahead over the shortest row walk of a block
        (the first chunk's, unprimed, or the last one's), and no further
        than the last of the ``planes`` a block walks (unless it walks
        outer dims too, whose planes follow on)."""
        n = -(-steps_j // clen)
        own = (n - 1) * clen
        shortest = min(min(clen, steps_j),
                       steps_j - own + min(self.prime, own))
        reach = -(-ring // max(shortest, 1))
        return reach if self.walk_dims else min(reach, max(planes - 1, 0))

    def _region(self, ni: int, walk: int, ring: int, ring_planes: int):
        """(floats, offsets, plane-window rows) of one block's region
        when it walks at most ``walk`` rows."""
        offs, total, prows = [], 0, []
        for kind, name in self.fast:
            rows = 0
            if (kind, name) in self.span:
                rows = walk + self.span[(kind, name)]
                prows.append(rows)
            elif kind == "shift" and ("plane", name) in self.span:
                rows = walk + self.span[("plane", name)]
            offs.append(total)
            total += _round4(self._floats(kind, name, ni, rows, ring,
                                          ring_planes))
        return total, offs, prows

    def _tiles(self, steps_j: int, gp: int, n_indep: int, n_walk: int,
               ni: int, threads: int, sms: int, per_sm, chunk, plane_chunk):
        """The (row-chunk, plane-chunk) lengths of a launch: the forced
        ones, else the pair whose walk takes the fewest row steps in
        waves of resident blocks, plus the partial rows one block of the
        device fold then folds after them (then the fewest waves, then
        the fewest row steps in all, then the most blocks), preferring
        windows in shared memory.
        Each count of chunks is a candidate, at its shortest length
        (``ceil(n / m)`` for ``m`` chunks: about ``2 sqrt(n)`` lengths).
        A call without plane windows is a call of one plane."""
        def lengths(forced, n):
            if forced is not None:
                if int(forced) < 1:
                    raise ValueError(f"chunk length must be >= 1, got "
                                     f"{forced}")
                return [int(forced)]
            out, m = [], 1
            while m <= n:
                out.append(-(-n // m))
                # the fewest chunks of a shorter length
                m = -(-n // (out[-1] - 1)) if out[-1] > 1 else n + 1
            return sorted(out)

        best = None
        for clen in lengths(chunk, steps_j):
            walk = min(clen + self.prime, steps_j)
            for plen in lengths(plane_chunk, gp):
                planes = min(plen + self.pprime, gp)
                _, _, fast, resident = self._ring(ni, steps_j, clen, walk,
                                                  planes, threads, per_sm)
                smem = fast * 4 <= SMEM_LIMIT
                if resident < 1:
                    continue
                nblocks = n_indep * -(-steps_j // clen) * -(-gp // plen)
                if not smem and nblocks * fast * 4 > MAX_GLOBAL_SCRATCH \
                        and (chunk is None or plane_chunk is None):
                    continue
                per_block = walk * planes * n_walk
                waves = -(-nblocks // (sms * resident))
                # a tie in row steps goes to fewer waves: each block pays
                # its ring's fill, which a walk without priming rows (a
                # prime of 0) does not show
                key = (not smem, waves * per_block + self._fold_rows(nblocks),
                       waves, nblocks * per_block, -nblocks)
                if best is None or key < best[0]:
                    best = (key, clen, plen)
        if best is None:  # nothing fits: one block per independent tile
            return steps_j, gp
        return best[1], best[2]

    def _fold_groups(self, nblocks: int) -> int:
        """Groups the device fold takes for ``nblocks`` blocks: where
        every accumulator is one row, made of one partial row a block,
        and they make whole groups of ``FOLD_GROUP`` (at least two);
        else 0, and one block folds them all."""
        if self.acc_outs and nblocks % FOLD_GROUP == 0 \
                and nblocks >= 2 * FOLD_GROUP \
                and all(self.acc_of(k).n_kept == 0 for k in self.acc_outs):
            return nblocks // FOLD_GROUP
        return 0

    def _fold_rows(self, nblocks: int) -> int:
        """Partial rows one block folds after the others finish (the
        last group's, or all of them)."""
        if not self.acc_outs:
            return 0
        return self._fold_groups(nblocks) or nblocks

    def concretize(self, sizes: tuple[int, ...], resident, chunk=None,
                   sms: int = H100_SMS, plane_chunk=None) -> Launch:
        """The launch for ``sizes`` = ``(*outer_sizes, Nj, Ni)`` on a
        card with ``sms`` SMs, each holding ``resident`` blocks of the
        built kernel: a count, or a function of a block's threads and
        shared-memory bytes (``kernel.build_call`` asks the built
        kernel).  ``chunk`` is the row-chunk length (a row tile of a call
        with plane windows) and ``plane_chunk`` the plane-chunk length;
        by default :meth:`_tiles` picks both."""
        call = self.call
        n_out = call.n_outer
        *outer, nj, ni = sizes
        per_sm = _per_sm(resident)
        gsz = tuple(outer[d] + call.outer_hi_off[d] - call.outer_lo[d]
                    for d in range(n_out))
        steps_j = max(0, nj + call.x_hi_off - call.x_lo)
        n_indep = math.prod(gsz[d] for d in self.indep_dims)
        threads = min(MAX_THREADS,
                      max(32, -(-ni // (32 * COLS_PER_THREAD)) * 32))
        gp = gsz[self.pdim] if self.planar else 1
        chunk_len, pchunk_len = max(steps_j, 1), max(gp, 1)
        if steps_j > 0 and gp > 0:
            n_walk = math.prod(gsz[d] for d in self.walk_dims)
            chunk_len, pchunk_len = self._tiles(
                steps_j, gp, n_indep, n_walk, ni, threads, sms, per_sm,
                chunk, plane_chunk)
        walk = min(chunk_len + self.prime, steps_j)
        ring, ring_planes, _, _ = self._ring(
            ni, steps_j, chunk_len, walk, min(pchunk_len + self.pprime, gp),
            threads, per_sm)
        fast, offs_f, prows = self._region(ni, walk, ring, ring_planes)
        use_smem = fast * 4 <= SMEM_LIMIT
        smem_bytes = fast * 4 if use_smem else 0
        nchunks = -(-steps_j // chunk_len)
        npchunks = -(-gp // pchunk_len)
        nblocks = n_indep * nchunks * npchunks
        vals = dict(ni=ni, nj=nj, steps_j=steps_j, chunk_len=chunk_len,
                    nchunks=nchunks, pchunk_len=pchunk_len,
                    npchunks=npchunks, nblocks=nblocks,
                    use_smem=int(use_smem), fast_floats=fast, ring=ring,
                    ring_planes=ring_planes)
        for d in range(n_out):
            vals[f"osz{d}"] = outer[d]
            vals[f"g{d}"] = gsz[d]
        for m, o in enumerate(offs_f):
            vals[f"off_f{m}"] = o
        for m, r in enumerate(prows):
            vals[f"prows{m}"] = r
        # the accumulators' partial rows and the fold's buffers after the
        # blocks' regions in the global scratch: the groups' results (one
        # row a group; a group of 16 folds in one pass), then the passes
        # of the last fold
        scratch = 0 if use_smem else nblocks * fast
        groups = self._fold_groups(nblocks)
        vals["fold_groups"] = groups
        for k in self.acc_outs:
            a = self.acc_of(k)
            tiles = math.prod(gsz[:a.n_kept])
            parts = nchunks * (npchunks if self.plane_reduced(a) else 1)
            vals[f"part{k}"] = scratch
            scratch += tiles * parts * (ni + a.w_off)
            vals[f"ptmp{k}"] = scratch
            rows = groups + -(-parts // 16) + -(-parts // 256)
            scratch += rows * (ni + a.w_off)
        res = per_sm(threads, smem_bytes) if nblocks else 0
        across = n_indep * math.prod(gsz[d] for d in self.walk_dims)
        return Launch(
            ints=tuple(int(vals[n]) for n in self.int_names),
            nblocks=nblocks, threads=threads, smem_bytes=smem_bytes,
            scratch_floats=scratch, gsz=gsz, steps_j=steps_j,
            nchunks=nchunks, ni=ni, sizes=tuple(sizes), npchunks=npchunks,
            chunk_len=chunk_len, pchunk_len=pchunk_len, resident=res,
            waves=-(-nblocks // (sms * res)) if res > 0 else 0,
            tickets=1 + groups, sms=sms,
            rows_walked=across * _walked(steps_j, chunk_len, self.prime)
            * _walked(gp, pchunk_len, self.pprime),
            rows_owned=across * steps_j * gp)

    def acc_of(self, k: int):
        """The accumulator of output ``k``."""
        name = self.call.outputs[k].acc
        return next(a for a in self.call.accs if a.name == name)


# ---------------------------------------------------------------------------
# The emitter
# ---------------------------------------------------------------------------

def _lin(dims, sizes) -> str:
    """C expression linearizing indices ``dims`` over ``sizes``."""
    expr = "0LL"
    for d, s in zip(dims, sizes):
        expr = f"({expr} * {s} + {d})"
    return expr


def emit_source(call: CallPlan, dtype="float32", batched: bool = False,
                seated: bool = False) -> str:
    """The CUDA source of ``call``'s kernel for element type ``dtype``
    (see the module docstring).  A bf16 or float16 source converts each
    element it loads to float and rounds each value it stores to a window
    or an output row; its float32 twin has no conversions.

    ``batched=True`` gives the kernel of a batch of examples in one
    launch: the blocks of a single call once for each example, the
    example the outermost factor of the grid.  Its parameters are a
    single call's, but that each input's pointer is that input's row of
    a table of the examples' addresses, followed by the bytes each other
    pointer (outputs, scratch, tickets) advances from one example to the
    next (``hfav::example``); each example's blocks run the single
    call's code on that example's operands, global scratch and fold
    tickets, so each example's bits are its single call's.

    ``seated=True`` stores each output of ``CallLayout(call, dtype,
    True).seated_outs`` in its goal array, ``(*osz, nj, ni)``, where the
    padded contract's row ``jid`` is goal row ``jid + x_lo + lead`` (of
    goal tiles ``op + outer_lead``): the rows and tiles of the seat take
    the values, and the border rows and tiles outside it zeros, each
    block zeroing its share of them after its row steps
    (``hfav::zero_border``) -- what ``assemble`` makes of the padded
    output.  Without it the source is the padded contract's."""
    lay = CallLayout(call, dtype, seated)
    et = ELEMENTS[lay.dtype][0]
    half = lay.itemsize == 2  # a 2-byte element: bf16 or float16
    to_float, from_float = CONVERSIONS.get(lay.dtype, (None, None))
    per = 16 // lay.itemsize  # elements a 16-byte piece

    def load(expr: str) -> str:
        return f"{to_float}({expr})" if half else expr

    def store(expr: str) -> str:
        return f"{from_float}({expr})" if half else expr
    n_out = call.n_outer
    nin = len(call.inputs)
    gs_ptr = nin + len(call.outputs)
    in_idx = {i.name: k for k, i in enumerate(call.inputs)}
    ispec_of = {i.name: i for i in lay.arr_ins}
    roll_of = {w.name: w for w in lay.roll_wins}
    pwin_of = {w.name: w for w in lay.plane_wins}
    acc_of = {a.name: a for a in call.accs}
    fptr = {(k, n): f"f{m}_{_ident(n)}" for m, (k, n) in enumerate(lay.fast)}
    prows = {key: f"prows{m}" for m, key in enumerate(lay.planes)}
    pidx = {key: m for m, key in enumerate(lay.planes)}
    regs = {n: f"L_{_ident(n)}" for n in lay.reg_locals}
    last = n_out - 1
    pd = lay.pdim

    def width(delta: int) -> str:
        return f"(ni + ({delta}))"

    def height(delta: int) -> str:
        return f"(nj + ({delta}))"

    def plane_row(key, pslot: str, row: str) -> str:
        """Offset, in rows, of ``row`` of plane slot ``pslot`` in a plane
        window of a row tile: the tile's rows at their distance from its
        lowest (``rb``)."""
        m = pidx[key]
        return f"({pslot} * {prows[key]} + ({row} - rb{m}))"

    def pstages(key) -> str:
        """The plane slots of a plane window (a plane input's ring adds
        ``ring_planes``)."""
        if key[0] == "plane":
            return f"ps{in_idx[key[1]]}"
        return str(pwin_of[key[1]].p_stages)

    def pslot(key, p_off: int) -> str:
        """The plane slot of a read at plane offset ``p_off``, from the
        row step's slot of the window's lead (``psl``)."""
        lead = lay._plane_writer(key)[1]
        if p_off == lead:
            return f"psl{pidx[key]}"
        return f"hfav::wrap(psl{pidx[key]} + ({p_off - lead}), {pstages(key)})"

    def src_row(i, pre: str, plane: str, xr: str) -> str:
        """The device-memory row of input ``i`` at row position ``xr``
        (plane position ``plane`` for a plane input), the outer
        positions those of cursor prefix ``pre``."""
        k = in_idx[i.name]
        ih, iw = height(i.j_hi - i.j_lo), width(i.i_hi - i.i_lo)
        pl = "0LL"
        ilos = i.outer_los or (0,) * i.n_outer
        ihis = i.outer_his or (0,) * i.n_outer
        for li, d in enumerate(range(n_out - i.n_outer, n_out)):
            npl = f"(osz{d} + ({ihis[li] - ilos[li]}))"
            p = plane if i.plane and d == last else f"{pre}op{d}"
            pl = (f"({pl} * {npl} + hfav::clamp({p} - ({ilos[li]}), 0, "
                  f"{npl} - 1))")
        return (f"(P.p[{k}] + ({pl} * {ih} + hfav::clamp({xr} - "
                f"({i.j_lo}), 0, {ih} - 1)) * {iw})")

    def decode(pre: str, cur: str) -> list[str]:
        """C lines setting the outer positions, the row and the row
        position of cursor ``cur``, names prefixed ``pre``."""
        lines = []
        if lay.walk_dims:
            lines.append(f"long long {pre}rest = {cur}.sq;")
        for d in reversed(lay.walk_dims):
            lines.append(f"const long long {pre}o{d} = {pre}rest % g{d};")
            lines.append(f"{pre}rest /= g{d};")
        if lay.planar:
            lines.append(f"const long long {pre}o{pd} = pc.first + {cur}.pi;")
        for d in lay.indep_dims:
            lines.append(f"const long long {pre}o{d} = b{d};")
        for d in range(n_out):
            lines.append(f"const long long {pre}op{d} = {pre}o{d} + "
                         f"({call.outer_lo[d]});")
        lines.append(f"const int {pre}jid = (int)ch.first + {cur}.ji;")
        lines.append(f"const int {pre}x = {pre}jid + ({call.x_lo});")
        lines.append(f"const int {pre}pq = {cur}.sq * nplanes + "
                     f"{cur}.pi;")
        return lines

    # -- kernel bodies -------------------------------------------------------
    bodies: dict[int, str] = {}
    for step in call.steps:
        if step.fn_idx in bodies:
            continue
        n_args = len(step.reads) + (1 if step.acc is not None else 0)
        n_outs = 1 if step.acc is not None else len(step.writes)
        bodies[step.fn_idx] = lower_body(call.fns[step.fn_idx], n_args,
                                         n_outs, f"hfav_fn{step.fn_idx}")

    out = []
    w = out.append
    w(f"// HFAV stencil kernel for CallPlan {call.name!r}"
      + (", over a batch of examples" if batched else "") + "; emitted by")
    w("// repro_torch/kernels/stencil2d/emit.py, machinery in stencil2d.cuh.")
    w('#include "stencil2d.cuh"')
    w("")
    w(f"#define HFAV_NP {lay.n_ptrs}")
    w(f"#define HFAV_ND {len(lay.int_names)}")
    if batched:
        w(f"#define HFAV_NI {nin}")
        w("#define HFAV_NB (HFAV_ND + HFAV_NP - HFAV_NI)")
    w("")
    for k in sorted(bodies):
        w(bodies[k])
        w("")
    etype = f", {et}" if half else ""
    w(f"__global__ void __launch_bounds__({MAX_THREADS})")
    if batched:
        w(f"hfav_kernel(const hfav::Params<HFAV_NP, HFAV_NB{etype}> PB) {{")
    else:
        w(f"hfav_kernel(const hfav::Params<HFAV_NP, HFAV_ND{etype}> P) {{")
    w("  extern __shared__ __align__(16) float hfav_smem[];")
    if batched:
        # the block's example, and that example's operands
        w(f"  const long long ex = blockIdx.x / PB.d["
          f"{lay.int_names.index('nblocks')}];")
        w(f"  const hfav::Params<HFAV_NP, HFAV_ND{etype}> P = "
          f"hfav::example<HFAV_ND, HFAV_NI>(PB, ex);")
    for k, name in enumerate(lay.int_names):
        w(f"  const long long {name} = P.d[{k}];")
    # the block within its example
    bid = "bid" if batched else "blockIdx.x"
    if batched:
        w("  const long long bid = blockIdx.x % nblocks;")
    w(f"  long long blk = {bid};")
    w("  const long long chunk = blk % nchunks;")
    w("  blk /= nchunks;")
    w("  const long long pchunk = blk % npchunks;")
    w("  blk /= npchunks;")
    for d in reversed(lay.indep_dims):
        w(f"  const long long b{d} = blk % g{d};")
        w(f"  blk /= g{d};")
    w(f"  float* const gscratch = "
      + (f"reinterpret_cast<float*>(P.p[{gs_ptr}]);" if half
         else f"P.p[{gs_ptr}];"))
    w("  float* const fast = hfav::fast_scratch(hfav_smem, gscratch, "
      "use_smem, fast_floats" + (", bid);" if batched else ");"))
    for m, key in enumerate(lay.fast):
        if key[0] == "shift":
            w(f"  int* const {fptr[key]} = reinterpret_cast<int*>(fast + "
              f"off_f{m});")
        elif half and key[0] in ("win", "plane", "pwin"):
            w(f"  {et}* const {fptr[key]} = reinterpret_cast<{et}*>(fast + "
              f"off_f{m});")
        else:
            w(f"  float* const {fptr[key]} = fast + off_f{m};")
    for i in call.inputs:
        k = in_idx[i.name]
        if i.scalar:
            w(f"  const float sc{k} = {load(f'P.p[{k}][0]')};")
        else:
            w(f"  const int cap{k} = (int)hfav::cap{per}("
              f"{width(i.i_hi - i.i_lo)});")
            if i.plane:
                w(f"  const int ps{k} = {i.p_stages} + (int)ring_planes;")
            else:
                w(f"  const int rs{k} = {i.stages} + (int)ring;")
    w(f"  const hfav::Chunk ch = hfav::chunk_of(chunk, chunk_len, steps_j, "
      f"{lay.prime});")
    if lay.planar:
        w(f"  const hfav::Chunk pc = hfav::chunk_of(pchunk, pchunk_len, "
          f"g{pd}, {lay.pprime});")
    nwalk = " * ".join(f"g{d}" for d in lay.walk_dims) or "1"
    for key, m in pidx.items():
        if key[0] == "plane":
            i = ispec_of[key[1]]
            h = height(i.j_hi - i.j_lo)
        else:
            pw = pwin_of[key[1]]
            h = height(pw.j_hi - pw.j_lo)
        w(f"  const int rb{m} = (int)hfav::clamp(ch.first + ({call.x_lo}) + "
          f"({lay.row_lo[key]}), 0, {h} - 1);")
    w("  const int nrows = (int)(ch.end - ch.first);")
    w("  const int nplanes = "
      + ("(int)(pc.end - pc.first);" if lay.planar else "1;"))
    w(f"  const int nsteps = (int)({nwalk}) * nplanes * nrows;")
    # the slots of the next issue and of the row step, per rolling input:
    # counters, not a modulo a step
    for i in lay.row_ins:
        k = in_idx[i.name]
        w(f"  int ib{k} = {i.lead}, tb{k} = 0;")

    # 1. the ring: the copies of one row step's input rows, issued `ring`
    # row steps ahead; a plane input's row clamped onto one it holds
    # already is not copied again
    w("  auto issue = [&](const hfav::Cursor& cf) {")
    for line in decode("f_", "cf"):
        w("    " + line)
    for i in lay.arr_ins:
        k = in_idx[i.name]
        iw = width(i.i_hi - i.i_lo)
        src = src_row(i, "f_", f"f_op{last} + ({i.p_lead})" if i.plane
                      else "", f"f_x + ({i.lead})")
        w("    {")
        w(f"      const {et}* const src = {src};")
        w(f"      const int sh = hfav::shift{per}(src);")
        # a 2-byte row may take the element before it, if in the tensor
        tensor = f", P.p[{k}]" if half else ""
        if i.plane:
            key = ("plane", i.name)
            ih = height(i.j_hi - i.j_lo)
            w(f"      const int r = f_x + ({i.lead - i.j_lo});")
            w(f"      if (cf.ji == 0 || (r > 0 && r < {ih})) {{")
            row = plane_row(key, f"hfav::slot(f_pq + ({i.p_lead}), ps{k})",
                            f"(int)hfav::clamp(r, 0, {ih} - 1)")
            w(f"        const int at = {row};")
            w(f"        if (threadIdx.x == 0) {fptr[('shift', i.name)]}[at] "
              f"= sh;")
            w(f"        hfav::issue_row({fptr[key]} + at * cap{k} + sh, src, "
              f"(int){iw}, use_smem{tensor});")
            w("      }")
        else:
            w(f"      const int at = ib{k};")
            w(f"      if (threadIdx.x == 0) "
              f"{fptr[('shift', 'in_' + i.name)]}[at] = sh;")
            w(f"      hfav::issue_row({fptr[('win', 'in_' + i.name)]} + "
              f"at * cap{k} + sh, src, (int){iw}, use_smem{tensor});")
        w("    }")
    w("  };")
    advance = "".join(f" ib{in_idx[i.name]} = hfav::next(ib{in_idx[i.name]}, "
                      f"rs{in_idx[i.name]});" for i in lay.row_ins)
    w("  hfav::Cursor pf = {0, 0, 0, 0};")
    w("  for (int d = 0; d < ring; ++d) {")
    w("    if (pf.t < nsteps) issue(pf);")
    w("    hfav::commit();")
    w("    pf.advance(nrows, nplanes);" + advance)
    w("  }")
    w("  for (hfav::Cursor cu = {0, 0, 0, 0}; cu.t < nsteps; "
      "cu.advance(nrows, nplanes)) {")
    w("    hfav::wait_ring_n((int)ring - 1);")
    w("    __syncthreads();")
    w("    if (pf.t < nsteps) issue(pf);")
    w("    hfav::commit();")
    w("    pf.advance(nrows, nplanes);" + advance)
    w("    // -- row step --")
    for line in decode("", "cu"):
        w("    " + line)
    own = "jid >= ch.own"
    if lay.planar:
        own += f" && o{pd} >= pc.own"
    w(f"    const bool own = {own};")
    for key, m in pidx.items():
        w(f"    const int psl{m} = hfav::slot(pq + "
          f"({lay._plane_writer(key)[1]}), {pstages(key)});")

    # 0. identity-initialize accumulators at the first step of a
    # block's walk through each kept tile (each thread its own columns)
    for a in call.accs:
        conds = ["jid == ch.first"] + [f"o{d} == 0" for d in lay.walk_dims
                                       if d >= a.n_kept]
        if lay.plane_reduced(a):
            conds.append(f"o{pd} == pc.first")
        w(f"    if ({' && '.join(conds)}) "
          f"hfav::fill_row({fptr[('acc', a.name)]}, "
          f"(int){width(a.w_off)}, {c_float(a.init)});")

    # 2. fused steps, in dataflow order, at their leads, in phases
    def operand(si, ri, rd):
        """(C expression of one operand at column c, preamble lines)."""
        if rd.src.startswith("local:"):
            name = rd.src[6:]
            if name in regs:
                return regs[name], []
            return f"{fptr[('local', name)]}[{rd.col0} + c]", []
        if rd.src.startswith("scalar:"):
            return f"sc{in_idx[rd.src[7:]]}", []
        ptr = f"s{si}_rd{ri}"
        if rd.src.startswith("in_") and rd.src[3:] in ispec_of:
            i = ispec_of[rd.src[3:]]
            k = in_idx[i.name]
            if i.plane:
                key = ("plane", i.name)
                ih = height(i.j_hi - i.j_lo)
                row = plane_row(key, pslot(key, rd.p_off),
                                f"(int)hfav::clamp(x + ({rd.j_off - i.j_lo}), "
                                f"0, {ih} - 1)")
                win, shf = fptr[key], fptr[("shift", i.name)]
            else:
                row = f"hfav::wrap(tb{k} + ({rd.j_off}), rs{k})"
                win, shf = fptr[("win", rd.src)], fptr[("shift", rd.src)]
            # (a slot not filled yet, in the unprimed head of a block's
            # walk, holds no shift: the mask keeps the read in its window)
            at = f"s{si}_at{ri}"
            return load(f"{win}[{ptr} + c]"), [
                f"const int {at} = {row};",
                f"const int {ptr} = {at} * cap{k} + ({shf}[{at}] & "
                f"{per - 1}) + ({rd.col0 - i.i_lo});"]
        if rd.src in pwin_of:
            pw = pwin_of[rd.src]
            key = ("pwin", pw.name)
            wh, bw = height(pw.j_hi - pw.j_lo), width(pw.i_hi - pw.i_lo)
            row = plane_row(key, pslot(key, rd.p_off),
                            f"(int)hfav::clamp(x + ({rd.j_off - pw.j_lo}), 0, "
                            f"{wh} - 1)")
            return load(f"{fptr[key]}[{ptr} + c]"), [
                f"const int {ptr} = {row} * (int){bw} + "
                f"({rd.col0 - pw.i_lo});"]
        b = roll_of[rd.src]
        bw = width(b.i_hi - b.i_lo)
        return load(f"{fptr[('win', b.name)]}[{ptr} + c]"), [
            f"const int {ptr} = hfav::slot(x + ({rd.j_off}), {b.stages}) * "
            f"(int){bw} + ({rd.col0 - b.i_lo});"]

    def seat_dims(o, names):
        """(name, extent, seat's lo and hi offsets) of each goal dim of
        output ``o``: its outer tiles, then its rows."""
        return list(zip(names, [f"osz{d}" for d in range(n_out)] + ["nj"],
                        o.outer_lo + (o.j_lo,), o.outer_hi + (o.j_hi,)))

    def seated_store(o, oi: int, dst: str, ok: str, pre: str, col0: int,
                     width_: str) -> list[str]:
        """C lines seating output ``oi``'s row of this row step: its goal
        tiles ``{pre}g<d>`` and row ``{pre}r`` (the inverse of
        ``assemble``'s trim), whether the block owns a row of the seat
        there (``ok``), the row ``dst``, and its columns outside the
        step's own filled as the padded row's are."""
        olead = o.outer_lead or (0,) * n_out
        g = [f"{pre}g{d}" for d in range(n_out)]
        r = f"{pre}r"
        lines = [f"const long long {g[d]} = op{d} + ({olead[d]});"
                 for d in range(n_out)]
        lines.append(f"const int {r} = x + ({o.lead});")
        conds = ["own"] + [f"{v} >= {lo} && {v} < {n} + ({hi})"
                           for v, n, lo, hi in seat_dims(o, g + [r])]
        lines.append(f"const bool {ok} = {' && '.join(conds)};")
        plane = _lin(g, [f"osz{d}" for d in range(n_out)])
        lines.append(f"{et}* const {dst} = {ok} ? P.p[{nin + oi}] + "
                     f"({plane} * nj + {r}) * ni : P.p[{nin + oi}];")
        lines.append(f"if ({ok}) hfav::fill_outside({dst}, (int)ni, {col0}, "
                     f"{col0} + {width_}, {c_float(o.fill)});")
        return lines

    for ph, steps in enumerate(lay.phases):
        if ph:
            w("    __syncthreads();")
        w(f"    {{  // phase {ph}: steps {', '.join(map(str, steps))}")
        pre_lines, loop_lines, reg_decl = [], [], []
        for si in steps:
            step = call.steps[si]
            pre_lines.append(f"// step {si}: {step.op}")
            pre_lines.append(f"const int s{si}_W = (int)"
                             f"{width(step.out_w_off)};")
            operands = []
            if step.acc is not None:
                operands.append(f"{fptr[('acc', step.acc)]}[c]")
            for ri, rd in enumerate(step.reads):
                expr, lines = operand(si, ri, rd)
                operands.append(expr)
                pre_lines += lines
            fname = f"hfav_fn{step.fn_idx}"
            body = []
            guard = f"c < s{si}_W"
            if step.acc is not None:
                lo, hi = step.valid
                conds = ["own", f"x + ({step.lead}) >= {lo}",
                         f"x + ({step.lead}) < nj + ({hi})"]
                for d, (vlo, vhi) in enumerate(step.valid_outer):
                    conds += [f"op{d} >= {vlo}", f"op{d} < osz{d} + ({vhi})"]
                pre_lines.append(f"const bool s{si}_on = "
                                 f"{' && '.join(conds)};")
                guard = f"s{si}_on && {guard}"
                acc = fptr[("acc", step.acc)]
                body.append(f"{acc}[c] = {fname}({', '.join(operands)});")
            else:
                if len(step.writes) == 1:
                    body.append(f"const float v0 = {fname}("
                                f"{', '.join(operands)});")
                else:
                    vs = [f"v{k}" for k in range(len(step.writes))]
                    body.append(f"float {', '.join(vs)};")
                    body.append(f"{fname}({', '.join(operands + vs)});")
                for vi, targets in enumerate(step.writes):
                    for ti, (kind, tgt) in enumerate(targets):
                        tgt_name = str(tgt)
                        dst = f"s{si}_dst{vi}_{ti}"
                        if kind == "local":
                            if tgt_name in regs:
                                reg_decl.append(regs[tgt_name])
                                body.append(f"{regs[tgt_name]} = v{vi};")
                            else:
                                body.append(
                                    f"{fptr[('local', tgt_name)]}[c] = "
                                    f"v{vi};")
                        elif kind == "buf" and tgt_name in pwin_of:
                            pw = pwin_of[tgt_name]
                            key = ("pwin", pw.name)
                            wh, bw = height(pw.j_hi - pw.j_lo), \
                                width(pw.i_hi - pw.i_lo)
                            seat = f"s{si}_seat{vi}_{ti}"
                            pre_lines.append(
                                f"const int {seat} = x + "
                                f"({step.lead - pw.j_lo});")
                            pre_lines.append(
                                f"const bool s{si}_ok{vi}_{ti} = {seat} >= 0 "
                                f"&& {seat} < {wh};")
                            row = plane_row(key, pslot(key, pw.p_lead), seat)
                            pre_lines.append(
                                f"{et}* const {dst} = {fptr[key]} + {row} * "
                                f"{bw} + ({step.out_col0 - pw.i_lo});")
                            body.append(f"if (s{si}_ok{vi}_{ti}) {dst}[c] = "
                                        f"{store(f'v{vi}')};")
                        elif kind == "buf":
                            b = roll_of[tgt_name]
                            bw = width(b.i_hi - b.i_lo)
                            pre_lines.append(
                                f"{et}* const {dst} = "
                                f"{fptr[('win', b.name)]} + hfav::slot(x + "
                                f"({step.lead}), {b.stages}) * {bw} + "
                                f"({step.out_col0 - b.i_lo});")
                            body.append(f"{dst}[c] = {store(f'v{vi}')};")
                        elif int(tgt) in lay.seated_outs:
                            dst_ok = f"s{si}_in{vi}_{ti}"
                            pre_lines += seated_store(
                                call.outputs[int(tgt)], int(tgt), dst, dst_ok,
                                f"s{si}_o{vi}_{ti}_", step.out_col0,
                                f"s{si}_W")
                            body.append(f"if ({dst_ok}) {dst}[{step.out_col0}"
                                        f" + c] = {store(f'v{vi}')};")
                        else:
                            oi = int(tgt)
                            outer_lin = _lin([f"o{d}" for d in range(n_out)],
                                             [f"g{d}" for d in range(n_out)])
                            pre_lines.append(
                                f"{et}* const {dst} = P.p[{nin + oi}] + "
                                f"({outer_lin} * steps_j + jid) * ni;")
                            pre_lines.append(
                                f"if (own) hfav::fill_outside({dst}, (int)ni, "
                                f"{step.out_col0}, {step.out_col0} + "
                                f"s{si}_W, "
                                f"{c_float(call.outputs[oi].fill)});")
                            body.append(f"if (own) {dst}[{step.out_col0} + c]"
                                        f" = {store(f'v{vi}')};")
            loop_lines.append(f"if ({guard}) {{  // step {si}")
            loop_lines += ["  " + b for b in body]
            loop_lines.append("}")
        for line in pre_lines:
            w("      " + line)
        wmax = f"s{steps[0]}_W"
        for si in steps[1:]:
            wmax = f"max({wmax}, s{si}_W)"
        w(f"      for (int c = threadIdx.x; c < {wmax}; c += blockDim.x) {{")
        if reg_decl:
            w(f"        float {', '.join(reg_decl)};")
        for line in loop_lines:
            w("        " + line)
        w("      }")
        w("    }")

    # 3. dump accumulators: a block's partial row for each kept tile,
    # after its last step there (a kept plane only where the block owns
    # it: a primed plane is another block's), into the global scratch
    for oi in lay.acc_outs:
        a = lay.acc_of(oi)
        conds = ["jid == ch.end - 1"] + [f"o{d} == g{d} - 1"
                                         for d in lay.walk_dims
                                         if d >= a.n_kept]
        if lay.plane_reduced(a):
            conds.append(f"o{pd} == pc.end - 1")
            nparts, part = "nchunks * npchunks", "pchunk * nchunks + chunk"
        else:
            if lay.planar:
                conds.append(f"o{pd} >= pc.own")
            nparts, part = "nchunks", "chunk"
        kept = _lin([f"o{d}" for d in range(a.n_kept)],
                     [f"g{d}" for d in range(a.n_kept)])
        acc = fptr[("acc", a.name)]
        w(f"    if ({' && '.join(conds)}) {{")
        w(f"      float* const part = gscratch + part{oi} + ({kept} * "
          f"({nparts}) + {part}) * {width(a.w_off)};")
        w(f"      for (int c = threadIdx.x; c < (int){width(a.w_off)}; "
          f"c += blockDim.x) part[c] = {acc}[c];")
        w("    }")
    for i in lay.row_ins:
        k = in_idx[i.name]
        w(f"    tb{k} = hfav::next(tb{k}, rs{k});")
    w("    // -- end of row step --")
    w("  }")
    w("  hfav::wait_ring_n(0);")
    # the seated outputs' border rows and tiles, outside their seat, hold
    # zero (as assemble's goal array): each block zeroes its share of them
    for oi in lay.seated_outs:
        o = call.outputs[oi]
        dims = seat_dims(o, [""] * (n_out + 1))
        if not any(lo or hi for _, _, lo, hi in dims):
            continue
        seat_a = [f"hfav::clamp({lo}, 0, {n})" for _, n, lo, _ in dims]
        seat_b = [f"hfav::clamp({n} + ({hi}), {a}, {n})"
                  for (_, n, _, hi), a in zip(dims, seat_a)]
        w(f"  hfav::zero_border<{n_out + 1}>(P.p[{nin + oi}], "
          f"{{{', '.join(n for _, n, _, _ in dims)}}}, "
          f"{{{', '.join(seat_a)}}}, {{{', '.join(seat_b)}}}, ni, {bid}, "
          f"nblocks);")

    # 4. the device fold of each accumulator's partial rows, in
    # lane_reduce's order: in groups of FOLD_GROUP (partial p in group
    # p % groups), the last block of each group folding it, the last
    # group folding the groups; else the last block folding them all
    if lay.acc_outs:
        w(f"  unsigned* const tickets = reinterpret_cast<unsigned*>("
          f"P.p[{gs_ptr + 1}]);")
        folds = []
        for oi in lay.acc_outs:
            a = lay.acc_of(oi)
            nparts = "nchunks * npchunks" if lay.plane_reduced(a) \
                else "nchunks"
            tiles = " * ".join(f"g{d}" for d in range(a.n_kept)) or "1"
            wd = f"(int){width(a.w_off)}"
            fn = (f"[](float a, float b) {{ return "
                  f"hfav_fn{lay.acc_fold[a.name]}(a, b); }}")
            folds.append((oi, nparts, tiles, wd, c_float(a.init), fn))
        w("  if (fold_groups) {")
        w(f"    const int g = (int)({bid} % fold_groups);")
        w(f"    if (hfav::last_block(tickets + 1 + g, {FOLD_GROUP})) {{")
        for oi, nparts, tiles, wd, init, fn in folds:
            w(f"      float* const res{oi} = gscratch + ptmp{oi};")
            w(f"      hfav::fold_rows(gscratch + part{oi} + g * {wd}, "
              f"fold_groups * {wd}, {FOLD_GROUP}, res{oi}, res{oi} + g * "
              f"{wd}, {wd}, {init}, {fn});")
        w("      if (hfav::last_block(tickets, fold_groups)) {")
        for oi, nparts, tiles, wd, init, fn in folds:
            w(f"        hfav::fold_rows(res{oi}, {wd}, (int)fold_groups, "
              f"res{oi} + fold_groups * {wd}, P.p[{nin + oi}], {wd}, "
              f"{init}, {fn});")
        w("      }")
        w("    }")
        w("  } else if (hfav::last_block(tickets, nblocks)) {")
        for oi, nparts, tiles, wd, init, fn in folds:
            w(f"    for (long long tile = 0; tile < {tiles}; ++tile)")
            w(f"      hfav::fold_rows(gscratch + part{oi} + tile * "
              f"({nparts}) * {wd}, {wd}, (int)({nparts}), gscratch + "
              f"ptmp{oi}, P.p[{nin + oi}] + tile * {wd}, {wd}, {init}, "
              f"{fn});")
        w("  }")
    w("}")
    w("")
    w("HFAV_ENTRY_POINTS(hfav_kernel, HFAV_NP, "
      + ("HFAV_NB)" if batched else "HFAV_ND)"))
    return "\n".join(out) + "\n"
