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
leaves one partial accumulator row per block (and kept tile); the host
folds them in block order with the plan's own combine body, as the host
half folds lanes.

What bounds it on the H100: every call streams each input row from
device memory once and writes each output row once, with a few flops
per element, so its bound is bytes over the memory rate.  A block's
windows (rolling rows, and the plane windows of its row tile) live in
shared memory when they fit, so a row read at several offsets costs one
trip to device memory and a contracted plane never goes there; row
chunks, and in a call with plane windows plane chunks times row tiles,
give every program enough blocks to fill the card.

The build (``nvcc`` at first use, cached by content in
``build/repro_torch/``) is :mod:`repro_torch.kernels.build`'s.  The kernel
refuses CPU tensors and any dtype but float32; a failed build or launch
raises.  :data:`launches` counts the launches made.
"""
from __future__ import annotations

import ctypes
import pathlib
import threading

import torch

from ...core.interpreters import (STENCIL_CAPABILITIES, InterpreterSpec,
                                  PlanUnsupported, register_interpreter,
                                  require_hazard_free, require_linked_fns)
from ...core.plan import CallPlan, fn_key
from ...core.runtime import lane_reduce
from .. import build
from .emit import H100_SMS, CallLayout, emit_source

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
HEADER = CSRC / "stencil2d.cuh"

#: Kernel launches made by :func:`run_kernel`.
launches = 0

_CALLS: dict = {}
_LOCK = threading.Lock()


def _bind(lib: ctypes.CDLL) -> None:
    lib.hfav_launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                ctypes.c_longlong, ctypes.c_int,
                                ctypes.c_longlong, ctypes.c_void_p]
    lib.hfav_launch.restype = ctypes.c_int
    lib.hfav_error_string.argtypes = [ctypes.c_int]
    lib.hfav_error_string.restype = ctypes.c_char_p


def job(call: CallPlan) -> build.Job:
    """The build job of ``call``'s emitted kernel."""
    return build.Job(emit_source(call), (HEADER,), CSRC, _bind)


def _call_key(call: CallPlan):
    return call, tuple(fn_key(f) for f in call.fns)


def layout(call: CallPlan) -> CallLayout:
    """``call``'s :class:`~repro_torch.kernels.stencil2d.emit.CallLayout`
    (memoized per plan and kernel bodies)."""
    key = _call_key(call)
    if key not in _CALLS:
        _CALLS[key] = [CallLayout(call), None]
    return _CALLS[key][0]


def build_library(call: CallPlan) -> ctypes.CDLL:
    """The loaded library of ``call``'s kernel, built on first use."""
    layout(call)
    entry = _CALLS[_call_key(call)]
    if entry[1] is None:
        with _LOCK:
            entry[1] = build.build([job(call)])[0][0]
    return entry[1]


def _check_tensor(t, what: str, shape, device) -> None:
    if not isinstance(t, torch.Tensor) or t.device.type != "cuda":
        raise ValueError(f"{what}: the CUDA stencil kernel takes CUDA "
                         f"tensors, got {getattr(t, 'device', type(t))}")
    if t.device != device:
        raise ValueError(f"{what}: on {t.device}, expected {device}")
    if t.dtype != torch.float32:
        raise ValueError(f"{what}: dtype {t.dtype}, expected float32")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{what}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: not contiguous")


def alloc_outputs(lay: CallLayout, run, device):
    """The kernel's padded outputs (accumulators as per-block partial
    rows: one per row chunk, and per plane chunk where the accumulator
    sums over the plane dim) and its global scratch, on ``device``."""
    outs = []
    for o in lay.call.outputs:
        if o.acc is None:
            shape = (*run.gsz, run.steps_j, run.ni)
        else:
            a = next(a for a in lay.call.accs if a.name == o.acc)
            parts = run.nchunks * (run.npchunks if lay.plane_reduced(a)
                                   else 1)
            shape = (*run.gsz[:a.n_kept], parts, run.ni + a.w_off)
        outs.append(torch.empty(shape, dtype=torch.float32, device=device))
    scratch = torch.empty(max(run.scratch_floats, 1), dtype=torch.float32,
                          device=device)
    return outs, scratch


def launch(lib, run, tensors, *, threads: int, stream) -> None:
    """One launch of ``lib``'s kernel over ``tensors`` (inputs, outputs,
    scratch); raises when the launch is refused."""
    ptrs = (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors])
    ints = (ctypes.c_longlong * len(run.ints))(*run.ints)
    rc = lib.hfav_launch(ptrs, ints, run.nblocks, threads, run.smem_bytes,
                         stream)
    if rc != 0:
        raise RuntimeError(f"stencil kernel launch failed: "
                           f"{lib.hfav_error_string(rc).decode()} ({rc})")


def run_kernel(lib, lay: CallLayout, run, args, *, threads: int, stream):
    """Allocate ``run``'s outputs and scratch beside ``args``, launch the
    kernel of ``lib`` on ``stream`` and fold each accumulator's per-block
    partial rows in a fixed order with the plan's combine body; returns
    the padded outputs under the reference contract."""
    global launches
    call = lay.call
    outs, scratch = alloc_outputs(lay, run, args[0].device)
    if run.nblocks:
        launch(lib, run, list(args) + outs + [scratch], threads=threads,
               stream=stream)
        launches += 1
    for k, o in enumerate(call.outputs):
        if o.acc is None:
            continue
        a = next(a for a in call.accs if a.name == o.acc)
        part = torch.movedim(outs[k], -2, 0)
        folded = lane_reduce(call.fns[lay.acc_fold[o.acc]], part, a.init)
        outs[k] = folded if a.n_kept else folded.reshape(1, -1)
    return outs if len(outs) > 1 else outs[0]


def build_call(call: CallPlan, sizes: tuple[int, ...], dtype, *,
               device=None, chunk=None, plane_chunk=None):
    """Concretize one :class:`CallPlan` on the CUDA kernel.

    ``sizes`` is ``(*outer_sizes, Nj, Ni)``; returns ``(fn, steps_j)``
    where ``fn`` maps the call's input tensors (scalars as ``(1, 1)``,
    on one CUDA device) to one padded output per ``call.outputs`` entry
    under the reference contract.  ``chunk`` is the row-chunk length
    (the row tile of a call with plane windows) and ``plane_chunk`` the
    plane-chunk length of a call with plane windows; by default
    :meth:`CallLayout.concretize` sizes both for at least one full wave
    of resident blocks on ``device``.  The kernel is built at the first
    call."""
    if dtype != torch.float32:
        raise PlanUnsupported(
            f"the CUDA stencil kernel builds for float32 only, not {dtype}")
    n_out = call.n_outer
    if len(sizes) != n_out + 2:
        raise ValueError(
            f"call {call.name} has n_outer={n_out} but got sizes {sizes}")
    require_linked_fns(call)
    require_hazard_free(call)
    lay = layout(call)
    dev = torch.device(device) if device is not None else None
    sms = torch.cuda.get_device_properties(dev).multi_processor_count \
        if dev is not None and dev.type == "cuda" else H100_SMS
    run = lay.concretize(tuple(sizes), chunk, sms, plane_chunk)
    *outer_sizes, nj, ni = sizes
    in_shapes = []
    for i in call.inputs:
        if i.scalar:
            in_shapes.append((1, 1))
            continue
        ilos = i.outer_los or (0,) * i.n_outer
        ihis = i.outer_his or (0,) * i.n_outer
        in_shapes.append(tuple(
            outer_sizes[d] + ihis[li] - ilos[li]
            for li, d in enumerate(range(n_out - i.n_outer, n_out)))
            + (nj + i.j_hi - i.j_lo, ni + i.i_hi - i.i_lo))

    lib = []  # the kernel's library, built at the first call

    def fn(*args):
        if len(args) != len(call.inputs):
            raise ValueError(f"call {call.name} takes {len(call.inputs)} "
                             f"inputs, got {len(args)}")
        dev = args[0].device if isinstance(args[0], torch.Tensor) else None
        for i, t, shape in zip(call.inputs, args, in_shapes):
            _check_tensor(t, f"input {i.name!r}", shape, dev)
        if not lib:
            lib.append(build_library(call))
        with torch.cuda.device(dev):
            return run_kernel(lib[0], lay, run, args, threads=run.threads,
                              stream=torch.cuda.current_stream(dev).cuda_stream)

    return fn, run.steps_j


register_interpreter(InterpreterSpec(
    name="cuda",
    build_call=build_call,
    # the reference Pallas kernel's set: unit-stride reads only, no
    # LayoutApply constructs (kernel.py:511-512 of the JAX package)
    capabilities=STENCIL_CAPABILITIES,
    dtypes=frozenset({torch.float32}),
    flags=frozenset({"chunk", "plane_chunk"}),
    description="hand-written CUDA stencil kernel for Hopper (sm_90a): "
                "one emitted source per CallPlan over csrc/stencil2d.cuh",
))
