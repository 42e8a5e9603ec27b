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
* :class:`CallLayout` fixes what a plan needs at run time: which outer
  dims go across blocks and which a block walks in order, how the row
  range splits into chunks and, in a call with plane windows, the plane
  dim into plane chunks (one block per pair: a plane chunk times a row
  tile), how far a block's walk starts before its first owned plane and
  row (the reach of the windows' reads behind their writes), where each
  window lives (a plane
  window holds only its block's row tile, in shared memory when the
  block's windows fit), and the order of the kernel's pointer and size
  parameters.  :meth:`CallLayout.concretize` gives their values for one
  problem size, choosing the chunk lengths for a full wave of blocks.

Sizes are runtime parameters, so one source (and one build) serves
every problem size of a plan.
"""
from __future__ import annotations

import math
import re
from dataclasses import dataclass

from ...core.interpreters import PlanUnsupported
from ...core.plan import CallPlan, WindowPlan

#: Most threads a block runs; they stride over the columns of a row,
#: about two columns each.
MAX_THREADS = 1024
#: Shared memory one block may use on Hopper (bytes), and one SM holds.
SMEM_LIMIT = 232448
SMEM_PER_SM = 233472
#: Threads one SM holds, and the SMs of an H100 (the default when the
#: device is not known).
THREADS_PER_SM = 2048
H100_SMS = 132


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
# The runtime layout of one call
# ---------------------------------------------------------------------------

def _ident(name: str) -> str:
    return re.sub(r"[^0-9A-Za-z_]", "_", name)


def _round4(n: int) -> int:
    return -(-n // 4) * 4


@dataclass(frozen=True)
class Launch:
    """One call's concrete launch: the size parameters in kernel order,
    the grid, and what the wrapper allocates."""

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


#: Registers a thread may hold under ``__launch_bounds__(MAX_THREADS)``
#: (the bound :meth:`CallLayout.concretize` assumes per block), the
#: registers and blocks of one SM, and the bytes of shared memory the
#: runtime reserves per block.
REGS_PER_THREAD = 64
REGS_PER_SM = 65536
BLOCKS_PER_SM = 32
SMEM_RESERVED = 1024
#: Global scratch the planner of a plane-window launch may ask for when
#: its windows do not fit shared memory (bytes).
MAX_GLOBAL_SCRATCH = 1 << 30


class CallLayout:
    """What one :class:`CallPlan` needs at run time (see the module
    docstring).  Raises :class:`PlanUnsupported` for calls outside the
    kernel's shape."""

    def __init__(self, call: CallPlan):
        self.call = call
        n_out = call.n_outer
        self.arr_ins = [i for i in call.inputs if not i.scalar]
        self.row_ins = [i for i in self.arr_ins if not i.plane]
        self.plane_ins = [i for i in self.arr_ins if i.plane]
        self.roll_wins = [WindowPlan(f"in_{i.name}", i.stages, i.i_lo, i.i_hi)
                          for i in self.row_ins] \
            + [w for w in call.windows if not w.plane]
        self.plane_wins = [w for w in call.windows if w.plane]
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
        # rows, locals, accumulators, then the plane windows of a row tile
        self.planes = [("plane", i.name) for i in self.plane_ins] \
            + [("pwin", w.name) for w in self.plane_wins]
        self.fast = [("win", w.name) for w in self.roll_wins] \
            + [("local", n) for n in self.local_w] \
            + [("acc", a.name) for a in call.accs] + self.planes
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
        back = pback = 0
        for key in self.planes:
            lead, p_lead, j_lo, src = self._plane_writer(key)
            reads = [r for s in call.steps for r in s.reads if r.src == src]
            if any(r.j_off > lead for r in reads):
                raise PlanUnsupported(
                    f"call {call.name}: plane window {key[1]} is read "
                    f"below the row it is written at; a row tile would "
                    f"have to walk past its last row")
            offs = [lead - j_lo] + [r.j_off - j_lo for r in reads]
            self.span[key] = max(offs) - min(offs)
            back += max([0] + [lead - r.j_off for r in reads])
            pback += max([0] + [p_lead - r.p_off for r in reads])
        # row steps a chunk's block runs before its first owned row: the
        # rows every rolling window can look back, and every plane
        # window's reads behind its writes; planes it runs before its
        # first owned plane
        self.prime = sum(w.stages for w in self.roll_wins) + back
        self.pprime = pback
        self.int_names = (
            ["ni", "nj", "steps_j", "chunk_len", "nchunks", "pchunk_len",
             "npchunks", "nblocks", "use_smem", "fast_floats"]
            + [f"osz{d}" for d in range(n_out)]
            + [f"g{d}" for d in range(n_out)]
            + [f"off_f{m}" for m in range(len(self.fast))]
            + [f"prows{m}" for m in range(len(self.planes))])
        self.n_ptrs = len(call.inputs) + len(call.outputs) + 1

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

    def _floats(self, kind: str, name: str, ni: int, rows: int) -> int:
        if kind == "win":
            w = next(w for w in self.roll_wins if w.name == name)
            return w.stages * (ni + w.i_hi - w.i_lo)
        if kind == "local":
            return ni + self.local_w[name]
        if kind == "acc":
            a = next(a for a in self.call.accs if a.name == name)
            return ni + a.w_off
        w = next(w for w in self.plane_ins + self.plane_wins
                 if w.name == name)
        return w.p_stages * rows * (ni + w.i_hi - w.i_lo)

    def plane_reduced(self, acc) -> bool:
        """Whether ``acc`` sums over the plane dim, so each plane chunk
        leaves a partial row of its own."""
        return self.planar and self.pdim >= acc.n_kept

    def _region(self, ni: int, walk: int):
        """(floats, offsets, plane-window rows) of one block's region
        when it walks at most ``walk`` rows."""
        offs, total, prows = [], 0, []
        for kind, name in self.fast:
            rows = 0
            if (kind, name) in self.span:
                rows = walk + self.span[(kind, name)]
                prows.append(rows)
            offs.append(total)
            total += _round4(self._floats(kind, name, ni, rows))
        return total, offs, prows

    def _resident(self, threads: int, fast: int) -> int:
        """Blocks one SM holds, by threads, registers and shared memory."""
        n = min(THREADS_PER_SM // threads, BLOCKS_PER_SM,
                REGS_PER_SM // (threads * REGS_PER_THREAD))
        if fast * 4 <= SMEM_LIMIT:
            n = min(n, SMEM_PER_SM // (fast * 4 + SMEM_RESERVED))
        return max(n, 1)

    def _plane_tiles(self, steps_j: int, gp: int, n_indep: int, n_walk: int,
                     ni: int, threads: int, sms: int, chunk, plane_chunk):
        """The (row-chunk, plane-chunk) lengths of a plane-window launch:
        the forced ones, else the pair whose walk takes the fewest row
        steps in waves of resident blocks (then the fewest row steps in
        all, then the most blocks, which hide more latency where an SM
        holds more of them than assumed), preferring windows in shared
        memory."""
        def lengths(forced, n):
            if forced is not None:
                if int(forced) < 1:
                    raise ValueError(f"chunk length must be >= 1, got "
                                     f"{forced}")
                return [int(forced)]
            out = {n}
            k = 1
            while k < n:
                out.add(k)
                k *= 2
            return sorted(out)

        best = None
        for clen in lengths(chunk, steps_j):
            walk = min(clen + self.prime, steps_j)
            fast = self._region(ni, walk)[0]
            smem = fast * 4 <= SMEM_LIMIT
            per_sm = self._resident(threads, fast)
            for plen in lengths(plane_chunk, gp):
                nblocks = n_indep * -(-steps_j // clen) * -(-gp // plen)
                if not smem and nblocks * fast * 4 > MAX_GLOBAL_SCRATCH \
                        and (chunk is None or plane_chunk is None):
                    continue
                per_block = walk * min(plen + self.pprime, gp) * n_walk
                waves = -(-nblocks // (sms * per_sm))
                key = (not smem, waves * per_block, nblocks * per_block,
                       -nblocks)
                if best is None or key < best[0]:
                    best = (key, clen, plen)
        if best is None:  # nothing fits: one block per independent tile
            return steps_j, gp
        return best[1], best[2]

    def concretize(self, sizes: tuple[int, ...], chunk=None,
                   sms: int = H100_SMS, plane_chunk=None) -> Launch:
        """The launch for ``sizes`` = ``(*outer_sizes, Nj, Ni)`` on a
        card with ``sms`` SMs.  ``chunk`` is the row-chunk length (a row
        tile of a call with plane windows) and ``plane_chunk`` the
        plane-chunk length.  By default a call without plane windows
        splits its rows into enough chunks for one full wave of resident
        blocks (as many as shared memory and threads let each SM hold);
        a call with plane windows takes the row tiles and plane chunks
        that :meth:`_plane_tiles` picks."""
        call = self.call
        n_out = call.n_outer
        *outer, nj, ni = sizes
        gsz = tuple(outer[d] + call.outer_hi_off[d] - call.outer_lo[d]
                    for d in range(n_out))
        steps_j = max(0, nj + call.x_hi_off - call.x_lo)
        n_indep = math.prod(gsz[d] for d in self.indep_dims)
        threads = min(MAX_THREADS, max(32, -(-ni // 64) * 32))
        gp = gsz[self.pdim] if self.planar else 1
        pchunk_len = max(gp, 1)
        if steps_j == 0 or gp == 0:
            chunk_len = max(steps_j, 1)
        elif self.planar:
            n_walk = math.prod(gsz[d] for d in self.walk_dims)
            chunk_len, pchunk_len = self._plane_tiles(
                steps_j, gp, n_indep, n_walk, ni, threads, sms, chunk,
                plane_chunk)
        elif chunk is None:
            fast = self._region(ni, 0)[0]
            per_sm = min(THREADS_PER_SM // threads,
                         SMEM_PER_SM // (fast * 4 * (fast * 4 <= SMEM_LIMIT)
                                         + SMEM_RESERVED))
            want = -(-sms * max(per_sm, 1) // max(n_indep, 1))
            chunk_len = -(-steps_j // min(steps_j, want))
        else:
            if int(chunk) < 1:
                raise ValueError(f"chunk length must be >= 1, got {chunk}")
            chunk_len = int(chunk)
        walk = min(chunk_len + self.prime, steps_j)
        fast, offs_f, prows = self._region(ni, walk)
        use_smem = fast * 4 <= SMEM_LIMIT
        smem_bytes = fast * 4 if use_smem else 0
        nchunks = -(-steps_j // chunk_len)
        npchunks = -(-gp // pchunk_len)
        nblocks = n_indep * nchunks * npchunks
        vals = dict(ni=ni, nj=nj, steps_j=steps_j, chunk_len=chunk_len,
                    nchunks=nchunks, pchunk_len=pchunk_len,
                    npchunks=npchunks, nblocks=nblocks,
                    use_smem=int(use_smem), fast_floats=fast)
        for d in range(n_out):
            vals[f"osz{d}"] = outer[d]
            vals[f"g{d}"] = gsz[d]
        for m, o in enumerate(offs_f):
            vals[f"off_f{m}"] = o
        for m, r in enumerate(prows):
            vals[f"prows{m}"] = r
        return Launch(
            ints=tuple(int(vals[n]) for n in self.int_names),
            nblocks=nblocks, threads=threads, smem_bytes=smem_bytes,
            scratch_floats=0 if use_smem else nblocks * fast,
            gsz=gsz, steps_j=steps_j, nchunks=nchunks, ni=ni,
            sizes=tuple(sizes), npchunks=npchunks, chunk_len=chunk_len,
            pchunk_len=pchunk_len)


# ---------------------------------------------------------------------------
# The emitter
# ---------------------------------------------------------------------------

def _lin(dims, sizes) -> str:
    """C expression linearizing indices ``dims`` over ``sizes``."""
    expr = "0LL"
    for d, s in zip(dims, sizes):
        expr = f"({expr} * {s} + {d})"
    return expr


def emit_source(call: CallPlan) -> str:
    """The CUDA source of ``call``'s kernel (see the module docstring)."""
    lay = CallLayout(call)
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
    last = f"op{n_out - 1}"
    pd = lay.pdim

    def width(delta: int) -> str:
        return f"(ni + ({delta}))"

    def height(delta: int) -> str:
        return f"(nj + ({delta}))"

    def plane_row(key, p_stages: int, plane: str, row: str) -> str:
        """Offset, in rows, of ``row`` of ``plane`` in a plane window of
        a row tile: floor-mod slots of both."""
        return (f"(hfav::slot({plane}, {p_stages}) * {prows[key]} + "
                f"hfav::slot({row}, {prows[key]}))")

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
    w(f"// HFAV stencil kernel for CallPlan {call.name!r}; emitted by")
    w("// repro_torch/kernels/stencil2d/emit.py, machinery in stencil2d.cuh.")
    w('#include "stencil2d.cuh"')
    w("")
    w(f"#define HFAV_NP {lay.n_ptrs}")
    w(f"#define HFAV_ND {len(lay.int_names)}")
    w("")
    for k in sorted(bodies):
        w(bodies[k])
        w("")
    w(f"__global__ void __launch_bounds__({MAX_THREADS})")
    w("hfav_kernel(const hfav::Params<HFAV_NP, HFAV_ND> P) {")
    w("  extern __shared__ float hfav_smem[];")
    for k, name in enumerate(lay.int_names):
        w(f"  const long long {name} = P.d[{k}];")
    w("  long long blk = blockIdx.x;")
    w("  const long long chunk = blk % nchunks;")
    w("  blk /= nchunks;")
    w("  const long long pchunk = blk % npchunks;")
    w("  blk /= npchunks;")
    for d in range(n_out):
        w(f"  long long o{d} = 0;")
    for d in reversed(lay.indep_dims):
        w(f"  o{d} = blk % g{d};")
        w(f"  blk /= g{d};")
    w(f"  float* const gscratch = P.p[{gs_ptr}];")
    w("  float* const fast = hfav::fast_scratch(hfav_smem, gscratch, "
      "use_smem, fast_floats);")
    for m, key in enumerate(lay.fast):
        w(f"  float* const {fptr[key]} = fast + off_f{m};")
    for i in call.inputs:
        if i.scalar:
            w(f"  const float sc{in_idx[i.name]} = P.p[{in_idx[i.name]}][0];")
    w(f"  const hfav::Chunk ch = hfav::chunk_of(chunk, chunk_len, steps_j, "
      f"{lay.prime});")
    if lay.planar:
        w(f"  const hfav::Chunk pc = hfav::chunk_of(pchunk, pchunk_len, "
          f"g{pd}, {lay.pprime});")
    nwalk = " * ".join(f"g{d}" for d in lay.walk_dims) or "1"
    w(f"  const long long nwalk = {nwalk};")
    w("  for (long long sq = 0; sq < nwalk; ++sq) {")
    if lay.walk_dims:
        w("    long long rest = sq;")
        for d in reversed(lay.walk_dims):
            w(f"    o{d} = rest % g{d};")
            w(f"    rest /= g{d};")
    if lay.planar:
        w(f"    for (o{pd} = pc.first; o{pd} < pc.end; ++o{pd}) {{")
    else:
        w("    {")
    for d in range(n_out):
        w(f"    const long long op{d} = o{d} + ({call.outer_lo[d]});")
    outer_lin = _lin([f"o{d}" for d in range(n_out)],
                     [f"g{d}" for d in range(n_out)])
    w("    for (long long jid = ch.first; jid < ch.end; ++jid) {")
    own = "jid >= ch.own"
    if lay.planar:
        own += f" && o{pd} >= pc.own"
    w(f"      const bool own = {own};")
    w(f"      const long long x = jid + ({call.x_lo});")

    # 0. identity-initialize accumulators at the first step of a
    # block's walk through each kept tile
    for a in call.accs:
        conds = ["jid == ch.first"] + [f"o{d} == 0" for d in lay.walk_dims
                                       if d >= a.n_kept]
        if lay.plane_reduced(a):
            conds.append(f"o{pd} == pc.first")
        w(f"      if ({' && '.join(conds)}) "
          f"hfav::fill_row({fptr[('acc', a.name)]}, "
          f"(int){width(a.w_off)}, {c_float(a.init)});")

    # 1. stream one new row per array input into its window
    for i in lay.arr_ins:
        k = in_idx[i.name]
        ih, iw = height(i.j_hi - i.j_lo), width(i.i_hi - i.i_lo)
        w("      {")
        w(f"        const long long r = hfav::clamp(x + ({i.lead - i.j_lo}), "
          f"0, {ih} - 1);")
        w("        long long pl = 0;")
        ilos = i.outer_los or (0,) * i.n_outer
        ihis = i.outer_his or (0,) * i.n_outer
        for li, d in enumerate(range(n_out - i.n_outer, n_out)):
            npl = f"(osz{d} + ({ihis[li] - ilos[li]}))"
            p = f"op{d}" + (f" + ({i.p_lead})" if i.plane and d == n_out - 1
                            else "")
            w(f"        pl = pl * {npl} + hfav::clamp({p} - ({ilos[li]}), 0, "
              f"{npl} - 1);")
        w(f"        const float* src = P.p[{k}] + (pl * {ih} + r) * {iw};")
        if i.plane:
            key = ("plane", i.name)
            row = plane_row(key, i.p_stages, f"{last} + ({i.p_lead})", "r")
            w(f"        hfav::stream_row({fptr[key]} + {row} * {iw}, src, "
              f"(int){iw});")
        else:
            w(f"        hfav::stream_row({fptr[('win', 'in_' + i.name)]} + "
              f"hfav::slot(x + ({i.lead}), {i.stages}) * {iw}, src, "
              f"(int){iw});")
        w("      }")
    w("      __syncthreads();")

    # 2. fused steps, in dataflow order, at their leads
    for si, step in enumerate(call.steps):
        w(f"      {{  // step {si}: {step.op}")
        w(f"        const int W = (int){width(step.out_w_off)};")
        operands = []
        if step.acc is not None:
            operands.append(f"{fptr[('acc', step.acc)]}[c]")
        for ri, rd in enumerate(step.reads):
            if rd.src.startswith("local:"):
                operands.append(
                    f"{fptr[('local', rd.src[6:])]}[{rd.col0} + c]")
            elif rd.src.startswith("scalar:"):
                operands.append(f"sc{in_idx[rd.src[7:]]}")
            elif rd.src.startswith("in_") and rd.src[3:] in ispec_of \
                    and ispec_of[rd.src[3:]].plane:
                i = ispec_of[rd.src[3:]]
                key = ("plane", i.name)
                ih, iw = height(i.j_hi - i.j_lo), width(i.i_hi - i.i_lo)
                row = plane_row(key, i.p_stages, f"{last} + ({rd.p_off})",
                                f"hfav::clamp(x + ({rd.j_off - i.j_lo}), 0, "
                                f"{ih} - 1)")
                w(f"        const float* rd{ri} = {fptr[key]} + {row} * {iw}"
                  f" + ({rd.col0 - i.i_lo});")
                operands.append(f"rd{ri}[c]")
            elif rd.src in pwin_of:
                pw = pwin_of[rd.src]
                key = ("pwin", pw.name)
                wh, bw = height(pw.j_hi - pw.j_lo), width(pw.i_hi - pw.i_lo)
                row = plane_row(key, pw.p_stages, f"{last} + ({rd.p_off})",
                                f"hfav::clamp(x + ({rd.j_off - pw.j_lo}), 0, "
                                f"{wh} - 1)")
                w(f"        const float* rd{ri} = {fptr[key]} + {row} * {bw}"
                  f" + ({rd.col0 - pw.i_lo});")
                operands.append(f"rd{ri}[c]")
            else:
                b = roll_of[rd.src]
                bw = width(b.i_hi - b.i_lo)
                w(f"        const float* rd{ri} = {fptr[('win', b.name)]} + "
                  f"hfav::slot(x + ({rd.j_off}), {b.stages}) * {bw} + "
                  f"({rd.col0 - b.i_lo});")
                operands.append(f"rd{ri}[c]")
        fname = f"hfav_fn{step.fn_idx}"
        if step.acc is not None:
            lo, hi = step.valid
            conds = ["own", f"x + ({step.lead}) >= {lo}",
                     f"x + ({step.lead}) < nj + ({hi})"]
            for d, (vlo, vhi) in enumerate(step.valid_outer):
                conds += [f"op{d} >= {vlo}", f"op{d} < osz{d} + ({vhi})"]
            acc = fptr[("acc", step.acc)]
            w(f"        if ({' && '.join(conds)}) {{")
            w("          for (int c = threadIdx.x; c < W; c += blockDim.x)")
            w(f"            {acc}[c] = {fname}({', '.join(operands)});")
            w("        }")
            w("      }")
            w("      __syncthreads();")
            continue
        stores = []  # (value index, C statement with {v})
        for vi, targets in enumerate(step.writes):
            for ti, (kind, tgt) in enumerate(targets):
                tgt_name = str(tgt)
                dst = f"dst{vi}_{ti}"
                if kind == "local":
                    stores.append((vi, f"{fptr[('local', tgt_name)]}[c] = "
                                       "{v};"))
                elif kind == "buf" and tgt_name in pwin_of:
                    pw = pwin_of[tgt_name]
                    key = ("pwin", pw.name)
                    wh, bw = height(pw.j_hi - pw.j_lo), \
                        width(pw.i_hi - pw.i_lo)
                    seat = f"seat{vi}_{ti}"
                    w(f"        const long long {seat} = x + "
                      f"({step.lead - pw.j_lo});")
                    w(f"        const bool ok{vi}_{ti} = {seat} >= 0 "
                      f"&& {seat} < {wh};")
                    row = plane_row(key, pw.p_stages,
                                    f"{last} + ({pw.p_lead})", seat)
                    w(f"        float* const {dst} = {fptr[key]} + {row} * "
                      f"{bw} + ({step.out_col0 - pw.i_lo});")
                    stores.append((vi, f"if (ok{vi}_{ti}) {dst}[c] = {{v}};"))
                elif kind == "buf":
                    b = roll_of[tgt_name]
                    bw = width(b.i_hi - b.i_lo)
                    w(f"        float* const {dst} = {fptr[('win', b.name)]} + "
                      f"hfav::slot(x + ({step.lead}), {b.stages}) * {bw} + "
                      f"({step.out_col0 - b.i_lo});")
                    stores.append((vi, f"{dst}[c] = {{v}};"))
                else:
                    oi = int(tgt)
                    w(f"        float* const {dst} = P.p[{nin + oi}] + "
                      f"({outer_lin} * steps_j + jid) * ni;")
                    w(f"        if (own) hfav::fill_outside({dst}, (int)ni, "
                      f"{step.out_col0}, {step.out_col0} + W, "
                      f"{c_float(call.outputs[oi].fill)});")
                    stores.append((vi, f"if (own) {dst}[{step.out_col0} + c]"
                                       " = {v};"))
        w("        for (int c = threadIdx.x; c < W; c += blockDim.x) {")
        if len(step.writes) == 1:
            w(f"          const float v0 = {fname}({', '.join(operands)});")
        else:
            vs = [f"v{k}" for k in range(len(step.writes))]
            w(f"          float {', '.join(vs)};")
            w(f"          {fname}({', '.join(operands + vs)});")
        for vi, stmt in stores:
            w("          " + stmt.format(v=f"v{vi}"))
        w("        }")
        w("      }")
        w("      __syncthreads();")

    # 3. dump accumulators: a block's partial row for each kept tile,
    # after its last step there (a kept plane only where the block owns
    # it: a primed plane is another block's)
    for oi, o in enumerate(call.outputs):
        if o.acc is None:
            continue
        a = acc_of[o.acc]
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
        w(f"      if ({' && '.join(conds)}) {{")
        w(f"        float* const part = P.p[{nin + oi}] + ({kept} * "
          f"({nparts}) + {part}) * {width(a.w_off)};")
        w(f"        for (int c = threadIdx.x; c < (int){width(a.w_off)}; "
          f"c += blockDim.x) part[c] = {acc}[c];")
        w("      }")
    w("      __syncthreads();")
    w("    }")
    w("    }")
    w("  }")
    w("}")
    w("")
    w("HFAV_ENTRY_POINTS(hfav_kernel, HFAV_NP, HFAV_ND)")
    return "\n".join(out) + "\n"
