"""K1's seated store: each ``external`` output the plan's rule admits
(``interpreters.seatable``) is stored by the kernel at its seat in a
goal-shaped array, borders included, so the host half neither fills nor
copies it.

Legs:

* the rule, read from the plan alone;
* the seated kernels compiled as host C++ (``-DHFAV_EMULATE``, every
  output starting as NaN, so an element the kernel neither stores nor
  fills shows) against ``assemble`` of the padded kernels' outputs, bit
  for bit: every program in float32, the programs with border rows, border
  tiles and a whole-array seat in bf16 and float16, single calls and a
  batch of 3 (whose blocks run in an order that interleaves the
  examples);
* the counters ``k1.seated`` and ``plan.reseated`` on the ``"cuda"``
  interpreter's host half (K1's callable emulated) and on
  ``interp_torch``;

plus the on-card case, which needs a CUDA device and ``nvcc`` and skips
without one.
"""
import concurrent.futures
import contextlib
import ctypes
import dataclasses
import hashlib
import shutil
import subprocess

import numpy as np
import pytest
import torch

from _inputs import hydro2d_state
from repro_torch import obs
from repro_torch.core import ALL_PROGRAMS, compile_program
from repro_torch.core.interpreters import (assemble, execute_plan,
                                           get_interpreter,
                                           register_interpreter, seatable,
                                           unregister_interpreter)
from repro_torch.kernels.stencil2d import kernel as k1
from repro_torch.kernels.stencil2d.emit import CallLayout, emit_source

EMULATE_H = k1.CSRC / "emulate.h"
#: Odd Ni: 2-byte rows start in turn on and between 4-byte words.
DIM = {"i": 37, "j": 9, "k": 4, "l": 3}
DTYPES = (torch.float32, torch.bfloat16, torch.float16)
#: Border rows (cosmo, j 2 -2), a whole-array seat (hydro1d, j 0 0),
#: border tiles (heat3d's plane dim, advect4d_halo's inner outer dim).
BORDERS = ("cosmo", "hydro1d", "heat3d", "advect4d_halo")
#: The stride of the emulated batched launch's block order.
BLOCK_STRIDE = 7


def _plan(name):
    return compile_program(ALL_PROGRAMS[name](), backend="interp_torch",
                           device="cpu").kernel_plan


def _dname(dtype) -> str:
    return str(dtype).removeprefix("torch.")


def inputs(name, kplan, rng, dtype, dims=DIM):
    """One seeded array per axiom (hydro1d's density positive), rounded
    to ``dtype`` and held as float32."""
    sizes = {sym: dims.get(d, 3) for d, sym in kplan.dim_sizes}
    out = {}
    for ax in kplan.axioms:
        ext = {d: (sym, lo, hi) for d, sym, lo, hi in ax.extents}
        shape = [sizes[ext[d][0]] + ext[d][2] - ext[d][1] for d in ax.dims]
        a = rng.standard_normal(shape).astype(np.float32)
        if name == "hydro1d" and ax.array == "rho":
            a = a * a + 1.0
        a = hydro2d_state(name, ax.array, a)
        out[ax.array] = torch.from_numpy(a).to(dtype).float()
    return out


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal dtype, shape and bits (a NaN equal to the same NaN)."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    view = {4: torch.int32, 2: torch.int16}[a.element_size()]
    return torch.equal(a.contiguous().view(view), b.contiguous().view(view))


# ---------------------------------------------------------------------------
# The rule
# ---------------------------------------------------------------------------

def test_seatable_reads_the_plan():
    """Every program's ``external`` outputs are seated (cosmo's j 2 -2
    at x_lo -2, hydro1d's whole array, heat3d's border planes, hydro2d's
    four), no
    other kind is, and an output whose producer runs tiles further ahead
    than the call's grid reaches keeps the re-seat."""
    seen = 0
    for name in sorted(ALL_PROGRAMS):
        for call in _plan(name).calls:
            if not call.has_grid:
                continue
            for out in call.outputs:
                assert seatable(call, out) == (out.kind == "external"), \
                    (name, out.name)
                seen += out.kind == "external"
            lay = CallLayout(call, seated=True)
            if not lay.seated_outs:  # nothing to seat: the padded source
                assert emit_source(call, seated=True) == emit_source(call)
    assert seen == 16
    call = _plan("heat3d").calls[0]
    out = call.outputs[0]
    assert (out.outer_lo, out.outer_hi, call.outer_lo) == ((1,), (-1,), (-1,))
    assert not seatable(call, dataclasses.replace(out, outer_lead=(3,)))
    assert not seatable(call, dataclasses.replace(out, lead=3))
    assert not seatable(call, dataclasses.replace(out, kind="full"))


# ---------------------------------------------------------------------------
# The emulated kernels
# ---------------------------------------------------------------------------

_EMU_LIBS: dict = {}


def _digest(src: str) -> str:
    return hashlib.sha256(src.encode() + k1.HEADER.read_bytes()
                          + EMULATE_H.read_bytes()).hexdigest()[:24]


def _compile(src: str, build_dir):
    digest = _digest(src)
    cpp, so = build_dir / f"{digest}.cpp", build_dir / f"{digest}.so"
    if not so.exists():
        cpp.write_text(src)
        out = subprocess.run(
            ["g++", "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread",
             "-DHFAV_EMULATE", f"-I{k1.CSRC}", "-o", str(so), str(cpp)],
            capture_output=True, text=True)
        assert out.returncode == 0, out.stderr[-4000:]
    return so


def _emulated(call, dtype, batched, seated, build_dir):
    src = emit_source(call, dtype, batched, seated)
    digest = _digest(src)
    if digest not in _EMU_LIBS:
        lib = ctypes.CDLL(str(_compile(src, build_dir)))
        k1._bind(lib)
        lib.hfav_emulate_block_stride.argtypes = [ctypes.c_longlong]
        lib.hfav_emulate_block_stride(BLOCK_STRIDE if batched else 1)
        _EMU_LIBS[digest] = lib
    return _EMU_LIBS[digest]


def _cases():
    return [(n, torch.float32) for n in sorted(ALL_PROGRAMS)] \
        + [(n, d) for n in BORDERS for d in DTYPES[1:]]


def _prebuild(build_dir):
    """Compile every case's single and batched sources, padded and
    seated, several compilers at a time."""
    srcs = {}
    for name, dtype in _cases():
        for call in _plan(name).calls:
            if call.has_grid:
                for batched in (False, True):
                    for seated in (False, True):
                        src = emit_source(call, dtype, batched, seated)
                        srcs[_digest(src)] = src
    with concurrent.futures.ThreadPoolExecutor(4) as pool:
        list(pool.map(lambda s: _compile(s, build_dir), srcs.values()))


def emulated_spec(spec, build_dir):
    """``spec`` (an ``InterpreterSpec``) with K1's callables emulated:
    the emitted sources, padded or seated as the host half asks, built
    as host C++ and launched on CPU tensors through ``k1.run_kernel``."""

    def build_call(call, sizes, dtype, *, device=None, chunk=None,
                   plane_chunk=None, seated=False):
        lay = CallLayout(call, dtype, seated)
        lib = _emulated(call, dtype, False, seated, build_dir)
        run = lay.concretize(tuple(sizes), k1.occupancy(lib), chunk,
                             plane_chunk=plane_chunk)

        def fn(*args):
            return k1.run_kernel(lib, lay, run, args, threads=3,
                                 stream=None)
        return fn, run.steps_j

    def build_batched(call, sizes, dtype, *, device=None, chunk=None,
                      plane_chunk=None, seated=False):
        lay = CallLayout(call, dtype, seated)
        single = _emulated(call, dtype, False, seated, build_dir)
        lib = _emulated(call, dtype, True, seated, build_dir)
        run = lay.concretize(tuple(sizes), k1.occupancy(single), chunk,
                             plane_chunk=plane_chunk)
        shapes = k1.input_shapes(call, sizes)

        def fn(*args):
            brun = k1.batch_launch(lay, run, shapes, args[0].shape[0])
            return k1.run_kernel(lib, lay, brun, args, threads=3,
                                 stream=None)
        return fn, run.steps_j

    return dataclasses.replace(spec, build_call=build_call,
                               build_batched=build_batched)


@contextlib.contextmanager
def poisoned_outputs():
    """Every output and scratch K1 allocates starts as NaN."""
    real = k1.alloc_outputs

    def poisoned(lay, run, device):
        outs, scratch = real(lay, run, device)
        for t in outs + [scratch]:
            t.fill_(float("nan"))
        return outs, scratch

    k1.alloc_outputs = poisoned
    try:
        yield
    finally:
        k1.alloc_outputs = real


@pytest.fixture(scope="module")
def emulators(tmp_path_factory):
    """Two emulated K1 interpreters, ``_emu_padded`` (the padded contract,
    re-seated by ``assemble``) and ``_emu_seated`` (``seats``), their
    outputs starting as NaN."""
    if shutil.which("g++") is None:
        pytest.skip("no host C++ compiler (g++) to emulate the kernels")
    build_dir = tmp_path_factory.mktemp("emulated_seated_kernels")
    _prebuild(build_dir)
    cuda = get_interpreter("cuda")
    assert cuda.seats
    for name, seats in (("_emu_padded", False), ("_emu_seated", True)):
        register_interpreter(dataclasses.replace(
            emulated_spec(cuda, build_dir), name=name, seats=seats))
    with poisoned_outputs():
        yield build_dir
    for name in ("_emu_padded", "_emu_seated"):
        unregister_interpreter(name)


@pytest.mark.parametrize("batch", [0, 3], ids=["single", "batch3"])
@pytest.mark.parametrize("name,dtype", _cases(),
                         ids=[f"{n}-{_dname(d)}" for n, d in _cases()])
def test_emulated_seated_outputs_are_assembles_bits(name, dtype, batch,
                                                    emulators):
    """The seated kernel's goals, every element of them, equal
    ``assemble`` of the padded kernel's outputs bit for bit (a NaN of the
    poisoned goal array would show), in row chunks of 2; the host half
    counts each seated output in ``k1.seated`` and re-seats none."""
    kplan = _plan(name)
    examples = [inputs(name, kplan, np.random.default_rng(40 + b), dtype)
                for b in range(max(batch, 1))]
    arrs = examples[0] if not batch else {
        k: torch.stack([e[k] for e in examples]) for k in examples[0]}
    run = {}
    for interp in ("_emu_padded", "_emu_seated"):
        seated0, reseated0 = obs.counter("k1.seated"), \
            obs.counter("plan.reseated")
        run[interp] = execute_plan(kplan, interpreter=interp, dtype=dtype,
                                   device="cpu", batched=bool(batch),
                                   chunk=2)(**arrs)
        run[interp + ".counts"] = (obs.counter("k1.seated") - seated0,
                                   obs.counter("plan.reseated") - reseated0)
    n_ext = sum(o.kind == "external" for c in kplan.calls if c.has_grid
                for o in c.outputs)
    assert run["_emu_padded.counts"] == (0, n_ext)
    assert run["_emu_seated.counts"] == (n_ext, 0)
    want, got = run["_emu_padded"], run["_emu_seated"]
    assert set(got) == set(want)
    for k in want:
        assert same_bits(got[k], want[k]), (name, k)
        assert not torch.isnan(got[k].float()).any() or \
            torch.isnan(want[k].float()).any(), (name, k)


@pytest.mark.parametrize("name,dims", [("cosmo", dict(DIM, j=4)),
                                       ("heat3d", dict(DIM, k=2))])
def test_emulated_empty_seat_is_all_zero(name, dims, emulators):
    """A size whose seat holds no row (cosmo's j 2 -2 at Nj = 4) or no
    plane (heat3d's at Nk = 2): the kernel stores no value, its blocks
    zero the whole goal as border, and the goal is ``assemble``'s, all
    zero, not the poisoned buffer."""
    kplan = _plan(name)
    arrs = inputs(name, kplan, np.random.default_rng(3), torch.float32,
                  dims)
    want, got = (execute_plan(kplan, interpreter=i, device="cpu")(**arrs)
                 for i in ("_emu_padded", "_emu_seated"))
    for k in want:
        assert not want[k].any(), k
        assert same_bits(got[k], want[k]), k


# ---------------------------------------------------------------------------
# The counters on the host half
# ---------------------------------------------------------------------------

def test_counters_on_the_cuda_host_half_and_on_interp_torch(emulators):
    """One cosmo call on the ``"cuda"`` interpreter's host half (K1's
    callable emulated) stores its one output at its seat: ``k1.seated``
    counts 1, ``plan.reseated`` 0.  On ``interp_torch``, which does not
    seat, nothing counts in ``k1.seated``, the output is re-seated (1)
    and is ``assemble``'s of the interpreter's padded output."""
    kplan = _plan("cosmo")
    arrs = inputs("cosmo", kplan, np.random.default_rng(9), torch.float32)
    cuda = get_interpreter("cuda")
    register_interpreter(emulated_spec(cuda, emulators))
    try:
        before = (obs.counter("k1.seated"), obs.counter("plan.reseated"),
                  obs.counter("k1.launch"))
        got = execute_plan(kplan, interpreter="cuda", device="cpu")(**arrs)
        after = (obs.counter("k1.seated"), obs.counter("plan.reseated"),
                 obs.counter("k1.launch"))
    finally:
        register_interpreter(cuda)
    assert [b - a for a, b in zip(before, after)] == [1, 0, 1]
    assert tuple(got["unew"].shape) == tuple(arrs["u"].shape)

    plain = get_interpreter("interp_torch")
    assert not plain.seats
    before = (obs.counter("k1.seated"), obs.counter("plan.reseated"))
    out = execute_plan(kplan, interpreter="interp_torch", device="cpu")(
        **arrs)
    after = (obs.counter("k1.seated"), obs.counter("plan.reseated"))
    assert [b - a for a, b in zip(before, after)] == [0, 1]
    call = kplan.calls[0]
    *n_outs, nj, ni = arrs["u"].shape
    padded = plain.build_call(call, (*n_outs, nj, ni), torch.float32,
                              device="cpu")[0](arrs["u"])
    want = assemble(call, call.outputs[0], padded, nj, ni, tuple(n_outs))
    assert same_bits(out["unew"], want)
    assert torch.equal(got["unew"][:, :2], torch.zeros_like(got["unew"][:, :2]))


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=_dname)
@pytest.mark.parametrize("name", sorted(ALL_PROGRAMS))
def test_cuda_seated_outputs_are_assembles_bits_on_card(name, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (run on the GPU)")
    kplan = _plan(name)
    arrs = {k: v.cuda() for k, v in
            inputs(name, kplan, np.random.default_rng(7), dtype).items()}
    seated = execute_plan(kplan, interpreter="cuda", dtype=dtype)
    # the padded contract through the same host half: ``"cuda"`` without
    # its seated store
    padded = dataclasses.replace(get_interpreter("cuda"),
                                 name="_cuda_padded", seats=False)
    register_interpreter(padded)
    try:
        before = obs.counter("k1.seated")
        got = seated(**arrs)
        torch.cuda.synchronize()
        assert obs.counter("k1.seated") > before or not any(
            o.kind == "external" for c in kplan.calls for o in c.outputs)
        ref = execute_plan(kplan, interpreter="_cuda_padded",
                           dtype=dtype)(**arrs)
    finally:
        unregister_interpreter("_cuda_padded")
    for k in ref:
        assert same_bits(got[k], ref[k]), (name, k)
