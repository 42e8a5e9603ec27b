"""The HFAV stencil kernel on Hopper: interpreter ``"cuda"``.

Replaces the Pallas TPU stencil interpreter
``src/repro/kernels/stencil2d/kernel.py:build_call`` (K1).  For each
:class:`~repro_torch.core.plan.CallPlan` the emitter
(:mod:`repro_torch.kernels.stencil2d.emit`) writes one CUDA C++ source
holding the plan's step sequence and lowered bodies over the hand
written machinery of ``csrc/stencil2d.cuh``; this module builds it with
``nvcc`` for ``sm_90a`` into a shared library with a plain C interface,
loads it with ``ctypes``, and launches it on PyTorch's current stream.

:func:`build_call` honors the padded-output contract of the reference
``build_call`` — row outputs ``(*grid, steps_j, Ni)``, carried
accumulators ``(1, w)``, kept-prefix accumulators ``(*grid[:n_kept], w)``
— so the shared host half assembles its outputs unchanged.  The kernel
leaves one partial accumulator row per block (and kept tile) in its
global scratch, and the last block to finish folds them with the plan's
own combine body in ``lane_reduce``'s order (atomic tickets, kept per
call and device in :data:`_TICKETS` and reset by the kernel).

What bounds it on the H100: every call streams each input row from
device memory once and writes each output row once, with a few flops
per element, so its bound is bytes over the memory rate.  A block's
windows (rolling rows, and the plane windows of its row tile) live in
shared memory when they fit, so a row read at several offsets costs one
trip to device memory and a contracted plane never goes there; row
chunks, and in a call with plane windows plane chunks times row tiles,
give every program enough blocks to fill the card: the chooser
(:meth:`CallLayout.concretize`) reads how many blocks an SM holds of the
built kernel (``hfav_occupancy``), so the launch is fixed at the first
call, after the build.  Each block keeps its input rows a few row steps
ahead in a ``cp.async`` ring.

Each call builds for float32, bf16 or float16 (one source and library
each).  In bf16 and float16 the inputs, outputs and windows hold the
2-byte type, where the reference stores in its dtype, and the arithmetic
runs in float; unlike the reference, the accumulators, their partial
rows and the fold stay float32 and round once, when the folded row is
written (the reference's 2-byte accumulator row, rounded at every row,
makes a long sum stagnate; see ``csrc/stencil2d.cuh``).

A batch of examples is one launch (:func:`build_batched`, the
counterpart of the reference's ``vmap`` over ``pallas_call``, whose
batching rule gives the Pallas grid a leading batch axis): a second
source per call and dtype (``emit_source(..., batched=True)``) runs a
single call's blocks once for each example, each on its own operands,
global scratch and fold tickets, at the single call's chunking, so each
example's bits are its single call's.  Its inputs are read through a
table of the examples' addresses (:func:`input_table`), so the examples
may be slices of one stacked tensor or each a tensor of its own, where
the caller holds it; its outputs are one stacked tensor.

The host half (:func:`~repro_torch.core.interpreters.execute_plan`) asks
for seated outputs (``seated=True``; the interpreter declares ``seats``):
each ``external`` output the plan's rule admits
(:func:`~repro_torch.core.interpreters.seatable`) is then stored at its
seat in a goal-shaped array, borders included, so the host neither fills
nor copies it.  Without ``seated`` the outputs keep the padded contract.

The build (``nvcc`` at first use, cached by content in
``build/repro_torch/``) is :mod:`repro_torch.kernels.build`'s.  The kernel
refuses CPU tensors and any dtype but float32, bf16 and float16; a failed
build or launch raises.  The counter ``k1.launch``
(:mod:`repro_torch.obs`) counts the launches made, ``launches`` reads it;
``k1.seated`` counts the outputs a launch stored at their seat;
``k1.rows_walked`` and ``k1.rows_owned`` the row steps its blocks walk
and own, ``k1.blocks`` its blocks and ``k1.block_slots`` the blocks its
waves hold (waves x SMs x blocks an SM holds), from the launch; each
source loaded adds 1 to ``k1.attrs`` and its registers and local (spill)
bytes a thread to ``k1.regs`` and ``k1.local_bytes``.
"""
from __future__ import annotations

import ctypes
import dataclasses
import math
import pathlib
import threading

import torch

from ...core.interpreters import (STENCIL_CAPABILITIES, InterpreterSpec,
                                  register_interpreter, require_hazard_free,
                                  require_linked_fns)
from ... import obs
from ...core.plan import CallPlan, fn_key
from .. import build
from .emit import H100_SMS, CallLayout, Launch, dtype_name, emit_source

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
HEADER = CSRC / "stencil2d.cuh"

_CALLS: dict = {}
_LOCK = threading.Lock()
#: The fold's tickets of each (call, device), and apart from them those
#: of its batched launches: int32, zero between launches (the kernel's
#: last blocks reset them).  A call's launches of one kind on one device
#: share them, so they must not overlap (one stream).
_TICKETS: dict = {}
#: Most blocks a launch's grid takes (``gridDim.x``).
MAX_GRID = 2**31 - 1


def _bind(lib: ctypes.CDLL) -> None:
    lib.hfav_launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                ctypes.c_longlong, ctypes.c_int,
                                ctypes.c_longlong, ctypes.c_void_p]
    lib.hfav_launch.restype = ctypes.c_int
    lib.hfav_occupancy.argtypes = [ctypes.c_int, ctypes.c_longlong]
    lib.hfav_occupancy.restype = ctypes.c_int
    lib.hfav_error_string.argtypes = [ctypes.c_int]
    lib.hfav_error_string.restype = ctypes.c_char_p
    lib.hfav_attrs.argtypes = [ctypes.c_void_p]
    lib.hfav_attrs.restype = ctypes.c_int


def attrs(lib: ctypes.CDLL) -> dict:
    """The built kernel's ``regs`` (registers a thread) and
    ``local_bytes`` (local memory a thread: spills and stack), from
    ``cudaFuncGetAttributes``; raises when the query fails."""
    out = (ctypes.c_longlong * 2)()
    rc = lib.hfav_attrs(out)
    if rc != 0:
        raise RuntimeError(f"stencil kernel attribute query failed: "
                           f"{lib.hfav_error_string(-rc).decode()} ({-rc})")
    return {"regs": out[0], "local_bytes": out[1]}


def job(call: CallPlan, dtype=torch.float32, batched: bool = False,
        seated: bool = False) -> build.Job:
    """The build job of ``call``'s emitted kernel for ``dtype`` (with
    ``batched``, of its kernel over a batch of examples; with ``seated``,
    of its kernel storing outputs at their seat)."""
    return build.Job(emit_source(call, dtype, batched, seated), (HEADER,),
                     CSRC, _bind)


def _call_key(call: CallPlan, dtype, seated: bool):
    return (call, tuple(fn_key(f) for f in call.fns), dtype_name(dtype),
            seated)


def layout(call: CallPlan, dtype=torch.float32,
           seated: bool = False) -> CallLayout:
    """``call``'s :class:`~repro_torch.kernels.stencil2d.emit.CallLayout`
    for ``dtype`` (memoized per plan, kernel bodies, dtype and
    ``seated``)."""
    key = _call_key(call, dtype, seated)
    if key not in _CALLS:
        _CALLS[key] = [CallLayout(call, dtype, seated), None, None]
    return _CALLS[key][0]


def build_library(call: CallPlan, dtype=torch.float32, batched: bool = False,
                  seated: bool = False) -> ctypes.CDLL:
    """The loaded library of ``call``'s kernel for ``dtype`` (with
    ``batched``, of its batched kernel; with ``seated``, storing outputs
    at their seat), built on first use.  The batched kernel's build
    builds the single call's beside it (one ``nvcc`` each, started
    together): the single kernel's residency fixes a batched launch."""
    layout(call, dtype, seated)
    entry = _CALLS[_call_key(call, dtype, seated)]
    missing = [b for b in ((False, True) if batched else (False,))
               if entry[1 + b] is None]
    if missing:
        with _LOCK:
            libs = build.build([job(call, dtype, b, seated)
                                for b in missing])[0]
            for b, lib in zip(missing, libs):
                a = attrs(lib)
                obs.count("k1.attrs")
                obs.count("k1.regs", a["regs"])
                obs.count("k1.local_bytes", a["local_bytes"])
                entry[1 + b] = lib
    return entry[1 + batched]


def _check_tensor(t, what: str, shape, device, dtype,
                  kind: str = "cuda") -> None:
    if not isinstance(t, torch.Tensor) or t.device.type != kind:
        raise ValueError(f"{what}: the CUDA stencil kernel takes "
                         f"{kind.upper()} tensors, got "
                         f"{getattr(t, 'device', type(t))}")
    if t.device != device:
        raise ValueError(f"{what}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{what}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{what}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: not contiguous")


def occupancy(lib):
    """Blocks of the built kernel ``lib`` an SM holds, as a function of a
    block's threads and shared-memory bytes (memoized); raises when the
    query fails."""
    memo = {}

    def resident(threads: int, smem_bytes: int) -> int:
        key = (threads, smem_bytes)
        if key not in memo:
            n = lib.hfav_occupancy(threads, smem_bytes)
            if n < 0:
                raise RuntimeError(
                    f"stencil kernel occupancy query failed: "
                    f"{lib.hfav_error_string(-n).decode()} ({-n})")
            memo[key] = n
        return memo[key]
    return resident


def input_shapes(call: CallPlan, sizes) -> list[tuple[int, ...]]:
    """The shape of each of ``call``'s inputs at ``sizes`` =
    ``(*outer_sizes, Nj, Ni)`` (a scalar's is ``(1, 1)``)."""
    n_out = call.n_outer
    *outer_sizes, nj, ni = sizes
    shapes = []
    for i in call.inputs:
        if i.scalar:
            shapes.append((1, 1))
            continue
        ilos = i.outer_los or (0,) * i.n_outer
        ihis = i.outer_his or (0,) * i.n_outer
        shapes.append(tuple(
            outer_sizes[d] + ihis[li] - ilos[li]
            for li, d in enumerate(range(n_out - i.n_outer, n_out)))
            + (nj + i.j_hi - i.j_lo, ni + i.i_hi - i.i_lo))
    return shapes


def output_shapes(lay: CallLayout, run) -> list[tuple[int, ...]]:
    """The output shapes of one example: a seated output's goal,
    ``(*outer_sizes, Nj, Ni)``; else the reference contract's padded
    shapes, row outputs ``(*grid, steps_j, Ni)``, accumulators ``(1, w)``
    or ``(*grid[:n_kept], w)``."""
    shapes = []
    for k, o in enumerate(lay.call.outputs):
        if k in lay.seated_outs:
            shapes.append(tuple(run.sizes))
        elif o.acc is None:
            shapes.append((*run.gsz, run.steps_j, run.ni))
        else:
            a = lay.acc_of(k)
            shapes.append((*run.gsz[:a.n_kept], run.ni + a.w_off)
                          if a.n_kept else (1, run.ni + a.w_off))
    return shapes


def alloc_outputs(lay: CallLayout, run, device):
    """The kernel's outputs (:func:`output_shapes`, with a
    leading batch axis in a batched launch) in ``lay``'s dtype, and its
    global scratch (the blocks' regions where they do not fit shared
    memory, the accumulators' partial rows; in 4-byte words, float32;
    one example's after another in a batched launch), on ``device``."""
    lead = (run.batch,) if run.batch else ()
    outs = [torch.empty(lead + shape, dtype=getattr(torch, lay.dtype),
                        device=device) for shape in output_shapes(lay, run)]
    scratch = torch.empty(max(run.scratch_floats, 1), dtype=torch.float32,
                          device=device)
    return outs, scratch


def tickets(lay: CallLayout, device, n: int,
            batched: bool = False) -> torch.Tensor:
    """At least ``n`` fold tickets of ``lay``'s call on ``device``, of
    its batched launches with ``batched`` (zeroed when made; the kernel
    leaves them zero)."""
    key = (lay, str(device), batched)
    if key not in _TICKETS or _TICKETS[key].numel() < n:
        _TICKETS[key] = torch.zeros(n, dtype=torch.int32, device=device)
    return _TICKETS[key]


def input_table(args, device) -> torch.Tensor:
    """The table of a batched launch's inputs: one row an input of
    ``args`` (each a sequence of the examples' tensors), holding each
    example's address (int64, on ``device``); the kernel finds example
    ``ex``'s input ``i`` at row ``i``, column ``ex`` (``hfav::example``).
    On the card it is filled in pinned host memory and copied on the
    current stream, so nothing waits for the device (the caching host
    allocator keeps the pinned block until the copy has run)."""
    table = torch.tensor([[t.data_ptr() for t in members]
                          for members in args], dtype=torch.int64,
                         pin_memory=device.type == "cuda")
    return table.to(device, non_blocking=True)


def launch_tensors(lay: CallLayout, run, args):
    """``(outputs, every tensor of a launch in kernel order)``: the
    inputs (in a batched launch, :func:`input_table`'s rows), freshly
    allocated outputs and scratch, and the tickets."""
    dev = (args[0][0] if run.batch else args[0]).device
    outs, scratch = alloc_outputs(lay, run, dev)
    ins = list(input_table(args, dev)) if run.batch else list(args)
    return outs, ins + outs + [
        scratch, tickets(lay, dev, run.tickets, batched=bool(run.batch))]


def batch_launch(lay: CallLayout, run: Launch, batch: int,
                 sms: int = H100_SMS) -> Launch:
    """The launch of the batched kernel over ``batch`` examples of the
    single call ``run``: its blocks once for each example, its size
    parameters followed by the bytes each pointer of the launch's own
    (outputs, scratch, tickets) advances from one example to the next;
    the inputs are read through :func:`input_table`.  Each example's
    scratch is the single call's, rounded up to 16 bytes, and its tickets
    are its own.  Raises ``ValueError`` past :data:`MAX_GRID` blocks."""
    nblocks = run.nblocks * batch
    if nblocks > MAX_GRID:
        raise ValueError(f"a batch of {batch} examples of {run.nblocks} "
                         f"blocks each is past the grid's {MAX_GRID} "
                         f"blocks")
    slab = -(-max(run.scratch_floats, 1) // 4) * 4
    strides = [math.prod(s) * lay.itemsize for s in output_shapes(lay, run)]
    strides += [4 * slab, 4 * run.tickets]
    return dataclasses.replace(
        run, ints=run.ints + tuple(strides), nblocks=nblocks,
        scratch_floats=slab * batch, tickets=run.tickets * batch,
        batch=batch, sms=sms, rows_walked=run.rows_walked * batch,
        rows_owned=run.rows_owned * batch,
        waves=-(-nblocks // (sms * run.resident)) if run.resident else 0)


def launch(lib, run, tensors, *, threads: int, stream) -> None:
    """One launch of ``lib``'s kernel over ``tensors`` (inputs, outputs,
    scratch, tickets); raises when the launch is refused."""
    ptrs = (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors])
    ints = (ctypes.c_longlong * len(run.ints))(*run.ints)
    rc = lib.hfav_launch(ptrs, ints, run.nblocks, threads, run.smem_bytes,
                         stream)
    if rc != 0:
        raise RuntimeError(f"stencil kernel launch failed: "
                           f"{lib.hfav_error_string(rc).decode()} ({rc})")


def count_launch(lay: CallLayout, run: Launch) -> None:
    """Add one launch of ``run`` to the counters (:mod:`repro_torch.obs`):
    ``k1.launch``, ``k1.folded`` where it folds an accumulator on the
    device, the outputs it seats, the row steps its blocks walk and own,
    its blocks and the blocks its waves hold."""
    obs.count("k1.launch")
    if lay.acc_outs:
        obs.count("k1.folded")
    if lay.seated_outs:
        obs.count("k1.seated", len(lay.seated_outs))
    obs.count("k1.rows_walked", run.rows_walked)
    obs.count("k1.rows_owned", run.rows_owned)
    obs.count("k1.blocks", run.nblocks)
    obs.count("k1.block_slots", run.waves * run.sms * run.resident)


def run_kernel(lib, lay: CallLayout, run, args, *, threads: int, stream):
    """Allocate ``run``'s outputs and scratch beside ``args`` and launch
    the kernel of ``lib`` on ``stream`` (which folds the accumulators);
    returns the outputs, seated or padded (:func:`output_shapes`).  A
    launch of no blocks leaves each accumulator at its identity and each
    seated output's goal at zero."""
    outs, tensors = launch_tensors(lay, run, args)
    if run.nblocks:
        launch(lib, run, tensors, threads=threads, stream=stream)
        count_launch(lay, run)
    else:
        for k in lay.acc_outs:
            outs[k].fill_(lay.acc_of(k).init)
        for k in lay.seated_outs:
            outs[k].zero_()
    return outs if len(outs) > 1 else outs[0]


def build_call(call: CallPlan, sizes: tuple[int, ...], dtype, *,
               device=None, chunk=None, plane_chunk=None, seated=False):
    """Concretize one :class:`CallPlan` on the CUDA kernel.

    ``sizes`` is ``(*outer_sizes, Nj, Ni)``; returns ``(fn, steps_j)``
    where ``fn`` maps the call's input tensors (scalars as ``(1, 1)``,
    on one CUDA device) to one padded output per ``call.outputs`` entry
    under the reference contract.  ``chunk`` is the row-chunk length
    (the row tile of a call with plane windows) and ``plane_chunk`` the
    plane-chunk length of a call with plane windows; by default
    :meth:`CallLayout.concretize` sizes both for the fewest row steps in
    waves of the blocks an SM holds of the built kernel.  The kernel is
    built, and its launch fixed, at the first call.  ``dtype`` is
    float32, bf16 or float16; any other raises
    :class:`PlanUnsupported`.  With ``seated``, each output
    :func:`~repro_torch.core.interpreters.seatable` admits comes back at
    its seat, in its goal's shape ``(*outer_sizes, Nj, Ni)``, as
    ``assemble`` would make it of the padded one."""
    return _build(call, sizes, dtype, chunk=chunk, plane_chunk=plane_chunk,
                  seated=seated)


def build_batched(call: CallPlan, sizes: tuple[int, ...], dtype, *,
                  device=None, chunk=None, plane_chunk=None, seated=False):
    """:func:`build_call` over a batch: ``fn`` maps the call's inputs,
    each a tensor with one leading batch axis or a sequence of the
    examples' tensors, of the same width ``B >= 1``, to its outputs
    (padded, or with ``seated`` as :func:`build_call`'s) with that leading
    axis, in **one** launch of the batched kernel for the whole batch.
    The kernel reads each example's inputs where they are, through a
    table of their addresses (:func:`input_table`): a sequence's tensors
    are neither stacked nor copied.  The launch is the single
    call's at ``sizes`` (its chunk and plane-chunk lengths, chosen from
    the single kernel's residency or forced as in :func:`build_call`),
    so each example's bits equal its single call's.  Both kernels are
    built at the first call; a failed build or launch raises."""
    return _build(call, sizes, dtype, chunk=chunk, plane_chunk=plane_chunk,
                  seated=seated, batched=True)


class _Card:
    """The facts of the device a K1 call runs on, the only ones
    :func:`_build` reads: the tensors' device type, how a kernel's library
    is loaded, the SMs, a block's threads, the device's context and the
    stream.  These are the card's; the tests' host emulation
    (``tests/_emulate.py``) substitutes its own."""

    kind = "cuda"

    def library(self, call: CallPlan, dtype, batched: bool, seated: bool):
        return build_library(call, dtype, batched, seated)

    def sms(self, dev) -> int:
        return torch.cuda.get_device_properties(dev).multi_processor_count

    def threads(self, run: Launch) -> int:
        return run.threads

    def device(self, dev):
        return torch.cuda.device(dev)

    def stream(self, dev):
        return torch.cuda.current_stream(dev).cuda_stream


_CARD = _Card()


def _build(call: CallPlan, sizes, dtype, *, device=None, chunk=None,
           plane_chunk=None, seated=False, batched=False, card=_CARD):
    """:func:`build_call`, or with ``batched`` :func:`build_batched`, on
    the device ``card`` describes."""
    dtype_name(dtype)  # raises PlanUnsupported for another dtype
    if len(sizes) != call.n_outer + 2:
        raise ValueError(f"call {call.name} has n_outer={call.n_outer} but "
                         f"got sizes {sizes}")
    require_linked_fns(call)
    require_hazard_free(call)
    lay = layout(call, dtype, seated)
    in_shapes = input_shapes(call, sizes)
    steps_j = max(0, sizes[-2] + call.x_hi_off - call.x_lo)
    built = []  # (library, single launch, SMs), fixed at the first call

    def fn(*args):
        if len(args) != len(call.inputs):
            raise ValueError(f"call {call.name} takes {len(call.inputs)} "
                             f"inputs, got {len(args)}")
        if batched:
            # each input as its examples' tensors: a stacked tensor's
            # slices, or the sequence as given
            args = [tuple(a.unbind(0)) if isinstance(a, torch.Tensor)
                    else tuple(a) for a in args]
            width = len(args[0])
            if width < 1 or any(len(a) != width for a in args):
                raise ValueError(f"call {call.name}: a batch needs one "
                                 f"width >= 1 for every input, got "
                                 f"{[len(a) for a in args]}")
        first = args[0][0] if batched else args[0]
        dev = first.device if isinstance(first, torch.Tensor) else None
        for i, a, shape in zip(call.inputs, args, in_shapes):
            for t in (a if batched else (a,)):
                _check_tensor(t, f"input {i.name!r}", shape, dev, dtype,
                              card.kind)
        with card.device(dev), obs.span("k1.launch"):
            if not built:
                with obs.span("kernel.build"):
                    lib = card.library(call, dtype, batched, seated)
                    sms = card.sms(dev)
                    # a batched launch is the single call's, once an
                    # example
                    resident = occupancy(card.library(call, dtype, False,
                                                      seated))
                    built.append((lib, lay.concretize(
                        tuple(sizes), resident, chunk, sms, plane_chunk),
                        sms))
            lib, run, sms = built[0]
            if batched:
                run = batch_launch(lay, run, width, sms)
            return run_kernel(lib, lay, run, args,
                              threads=card.threads(run),
                              stream=card.stream(dev))

    return fn, steps_j


def __getattr__(name: str):
    if name == "launches":  # the ``k1.launch`` counter, read as before
        return obs.counter("k1.launch")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


register_interpreter(InterpreterSpec(
    name="cuda",
    build_call=build_call,
    build_batched=build_batched,
    seats=True,
    # the reference Pallas kernel's set: unit-stride reads only, no
    # LayoutApply constructs (kernel.py:511-512 of the JAX package)
    capabilities=STENCIL_CAPABILITIES,
    dtypes=frozenset({torch.float32, torch.bfloat16, torch.float16}),
    flags=frozenset({"chunk", "plane_chunk"}),
    description="hand-written CUDA stencil kernel for Hopper (sm_90a): "
                "one emitted source per CallPlan over csrc/stencil2d.cuh",
))
