"""The CUDA emitter: kernel bodies lower to C deterministically, every
plan's source is stable, and the emitted kernels compute what the plain
interpreter computes.

Three legs:

* the tracer, on every program's bodies (float literals carry an ``f``
  suffix; unsupported operations raise when the source is emitted);
* the emitted ``.cu`` of every golden plan, identical on two runs;
* the emitted kernels compiled as host C++ (``-DHFAV_EMULATE``: blocks
  one after another, a block's threads as host threads meeting at a
  barrier in ``__syncthreads``) and held against ``interp_torch`` with
  small forced row chunks, which tests the kernels' slot, clamp, chunk,
  priming and ownership logic without a GPU;

plus the on-card cases, which need a CUDA device and ``nvcc`` and skip
without one.
"""
import ctypes
import hashlib
import json
import pathlib
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from repro_torch.core import (ALL_PROGRAMS, PlanUnsupported,
                              compile_program, from_reference_dict)
from repro_torch.core.interpreters import (STENCIL_CAPABILITIES,
                                           InterpreterSpec,
                                           register_interpreter,
                                           unregister_interpreter)
from repro_torch.core.plan import acc_init_wrap
from repro_torch.kernels.stencil2d import kernel as k1
from repro_torch.kernels.stencil2d.emit import (CallLayout, LoweringError,
                                                c_float, emit_source,
                                                lower_body)

GOLDEN_DIR = pathlib.Path(__file__).resolve().parent / "goldens" / "plans"
DIM = {"i": 20, "j": 7, "k": 4, "l": 3}


def _plan(name):
    return compile_program(ALL_PROGRAMS[name](), backend="interp_torch",
                           device="cpu").kernel_plan


def _steps(kplan):
    for call in kplan.calls:
        for step in call.steps:
            n_args = len(step.reads) + (step.acc is not None)
            n_outs = 1 if step.acc is not None else len(step.writes)
            yield call.fns[step.fn_idx], n_args, n_outs


# ---------------------------------------------------------------------------
# The tracer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(ALL_PROGRAMS))
def test_bodies_lower_deterministically(name):
    for fn, n_args, n_outs in _steps(_plan(name)):
        a = lower_body(fn, n_args, n_outs, "f")
        assert a == lower_body(fn, n_args, n_outs, "f")
        # every float literal is single precision
        lits = re.findall(r"(?<![\w.])\d+\.\d*(?:e-?\d+)?f?", a)
        assert all(lit.endswith("f") for lit in lits), a


def test_literals_and_selects():
    from repro_torch.core.programs import _rsqrt_n, _slope, _trace
    assert c_float(4) == "4.0f"
    assert c_float(-0.25) == "(-0.25f)"
    assert c_float(1e-30) == "1e-30f"
    slope = lower_body(_slope, 3, 1, "slope")
    assert "?" in slope and "1e-30f" in slope and "2.0f" in slope
    assert "sqrtf(" in lower_body(_rsqrt_n, 1, 1, "r")
    trace = lower_body(_trace, 2, 2, "trace")
    assert "float& r0, float& r1" in trace and "r1 = " in trace


def test_row_kept_init_wrapper_lowers_to_a_literal():
    from repro_torch.core.programs import _sum2
    src = lower_body(acc_init_wrap(_sum2, 0.0), 1, 1, "w")
    assert "(0.0f + a0)" in src


def _branchy(a):
    return a if a > 0 else -a


def _powered(a):
    return a ** 2


def _torch_call(a):
    return torch.exp(a)


@pytest.mark.parametrize("fn", [_branchy, _powered, _torch_call])
def test_unsupported_operations_raise_when_emitted(fn):
    with pytest.raises(LoweringError):
        lower_body(fn, 1, 1, "bad")
    assert issubclass(LoweringError, PlanUnsupported)


def test_wrong_output_count_raises():
    from repro_torch.core.programs import _trace
    with pytest.raises(LoweringError, match="returns 2"):
        lower_body(_trace, 2, 1, "bad")


# ---------------------------------------------------------------------------
# Per-plan sources
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(ALL_PROGRAMS))
def test_golden_plan_sources_are_stable(name):
    kplan = from_reference_dict(
        json.loads((GOLDEN_DIR / f"{name}.json").read_text()))
    for call in kplan.calls:
        if not call.has_grid:
            continue
        a, b = emit_source(call), emit_source(call)
        assert a == b
        assert '#include "stencil2d.cuh"' in a
        assert "HFAV_ENTRY_POINTS(hfav_kernel" in a
        assert emit_source(_plan(name).calls[kplan.calls.index(call)]) == a


def _owners(run, lay):
    """Each block's owned (plane, row) steps and its walk, by the
    formulas of ``hfav::chunk_of``: ``{(pchunk, chunk): (owned steps,
    first plane, first row)}``."""
    gp = run.gsz[lay.pdim]
    out = {}
    for pc in range(run.npchunks):
        p_own = pc * run.pchunk_len
        p_end = min(p_own + run.pchunk_len, gp)
        for c in range(run.nchunks):
            own = c * run.chunk_len
            end = min(own + run.chunk_len, run.steps_j)
            out[pc, c] = ({(o, j) for o in range(p_own, p_end)
                           for j in range(own, end)},
                          max(p_own - lay.pprime, 0),
                          max(own - lay.prime, 0))
    return out


def test_chunking_and_plane_calls():
    """2-D calls split their rows into chunks; plane-window calls split
    their plane dim into plane chunks and each plane's rows into row
    tiles, one block per pair (and independent outer tile), every
    (plane, row) step owned by exactly one block, each block's walk
    starting the plane prime and the row prime early."""
    norm = CallLayout(_plan("normalization").calls[0])
    run = norm.concretize((4096, 2048))
    assert run.nblocks >= 132 and run.nchunks == run.nblocks
    assert norm.concretize((4096, 2048), chunk=8).nchunks == 512
    heat = CallLayout(_plan("advect4d_halo").calls[0])
    assert heat.planar and heat.seq_dims == [1] and heat.indep_dims == [0]
    assert heat.pdim == 1 and heat.walk_dims == []
    # u[k-1], u[k+1]: two planes behind the streamed one; rows at j only
    assert (heat.pprime, heat.prime) == (2, 0)
    run = heat.concretize((3, 5, 37, 200), chunk=3, plane_chunk=2)
    assert (run.nchunks, run.npchunks, run.nblocks) == (13, 3, 3 * 13 * 3)
    assert run.smem_bytes > 0 and run.scratch_floats == 0
    owned = _owners(run, heat)
    assert len(owned) == run.nchunks * run.npchunks
    steps = [s for o, _, _ in owned.values() for s in o]
    assert sorted(steps) == [(o, j) for o in range(run.gsz[1])
                             for j in range(run.steps_j)]
    assert owned[1, 4][1:] == (0, 12) and owned[2, 0][1:] == (2, 0)
    stage = CallLayout(_plan("heat3d_stage").calls[0])
    # the producer plane window is read a row behind its write plus one
    # more (rows x - 1 .. x + 1 of a window written at x + 1)
    assert (stage.pprime, stage.prime) == (2, 2)
    cosmo = CallLayout(_plan("cosmo").calls[0])
    assert cosmo.indep_dims == [0] and cosmo.seq_dims == []
    energy = CallLayout(_plan("energy3d").calls[0])
    assert energy.seq_dims == [0] and energy.walk_dims == [0]


@pytest.mark.parametrize("name,sizes", [
    ("heat3d", (64, 512, 512)), ("heat3d_stage", (64, 512, 512)),
    ("heat3d_residual_norm", (64, 512, 512)),
    ("advect4d_halo", (4, 16, 512, 512))])
def test_plane_window_calls_fill_the_card_from_shared_memory(name, sizes):
    """At the sizes the smoke run times, the default launch of every
    plane-window call is at least one wave of 132 blocks, with its plane
    windows in shared memory."""
    lay = CallLayout(_plan(name).calls[0])
    run = lay.concretize(sizes)
    assert run.nblocks >= 132
    assert 0 < run.smem_bytes <= 232448 and run.scratch_floats == 0
    assert run.nchunks > 1


# ---------------------------------------------------------------------------
# The emitted kernels, compiled as host C++
# ---------------------------------------------------------------------------

_EMU_LIBS: dict = {}


def _emulated(call, build_dir):
    src = emit_source(call)
    digest = hashlib.sha256(src.encode()
                            + k1.HEADER.read_bytes()).hexdigest()[:24]
    if digest not in _EMU_LIBS:
        cpp = build_dir / f"{digest}.cpp"
        so = build_dir / f"{digest}.so"
        cpp.write_text(src)
        out = subprocess.run(
            ["g++", "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread",
             "-DHFAV_EMULATE", f"-I{k1.CSRC}", "-o", str(so), str(cpp)],
            capture_output=True, text=True)
        assert out.returncode == 0, out.stderr[-4000:]
        lib = ctypes.CDLL(str(so))
        lib.hfav_launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                    ctypes.c_longlong, ctypes.c_int,
                                    ctypes.c_longlong, ctypes.c_void_p]
        lib.hfav_error_string.restype = ctypes.c_char_p
        _EMU_LIBS[digest] = lib
    return _EMU_LIBS[digest]


@pytest.fixture(scope="module")
def emulator(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("no host C++ compiler (g++) to emulate the kernels")
    build_dir = tmp_path_factory.mktemp("emulated_kernels")

    def build_call(call, sizes, dtype, *, device=None, chunk=None,
                   plane_chunk=None):
        lay = CallLayout(call)
        run = lay.concretize(tuple(sizes), chunk, plane_chunk=plane_chunk)

        def fn(*args):
            return k1.run_kernel(_emulated(call, build_dir), lay, run,
                                 args, threads=3, stream=None)
        return fn, run.steps_j

    def poisoned(lay, run, device):  # a step no block writes stays NaN
        outs, scratch = alloc_outputs(lay, run, device)
        for t in outs + [scratch]:
            t.fill_(float("nan"))
        return outs, scratch

    alloc_outputs = k1.alloc_outputs
    k1.alloc_outputs = poisoned
    register_interpreter(InterpreterSpec(
        "_emulated_cuda", build_call, STENCIL_CAPABILITIES,
        flags=frozenset({"chunk", "plane_chunk"})))
    yield "_emulated_cuda"
    unregister_interpreter("_emulated_cuda")
    k1.alloc_outputs = alloc_outputs


def _arrays(kplan, rng, dims=DIM):
    sizes = {sym: dims.get(d, 3) for d, sym in kplan.dim_sizes}
    out = {}
    for ax in kplan.axioms:
        ext = {d: (sym, lo, hi) for d, sym, lo, hi in ax.extents}
        shape = [sizes[ext[d][0]] + ext[d][2] - ext[d][1] for d in ax.dims]
        out[ax.array] = rng.standard_normal(shape).astype(np.float32)
    return out


@pytest.mark.parametrize("name", sorted(ALL_PROGRAMS))
def test_emulated_kernel_matches_plain_interpreter(name, emulator):
    ref = compile_program(ALL_PROGRAMS[name](), backend="interp_torch",
                          device="cpu")
    arrs = _arrays(ref.kernel_plan, np.random.default_rng(5))
    want = ref.fn(**arrs)
    for chunk in (1, 2, None):
        got = compile_program(ALL_PROGRAMS[name](), backend=emulator,
                              device="cpu", chunk=chunk).fn(**arrs)
        for k in want:
            np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                       atol=2e-4, rtol=1e-3,
                                       err_msg=f"{name}/chunk={chunk}:{k}")


PLANE_WINDOW_PROGRAMS = ("heat3d", "heat3d_stage", "heat3d_residual_norm",
                         "advect4d_halo")


@pytest.mark.parametrize("plane_chunk", [1, 2, 3])
@pytest.mark.parametrize("chunk", [1, 3, None])
@pytest.mark.parametrize("nk", [1, 4])
@pytest.mark.parametrize("name", PLANE_WINDOW_PROGRAMS)
def test_emulated_plane_chunks_and_row_tiles(name, nk, chunk, plane_chunk,
                                             emulator):
    """Forced plane chunks of 1, 2 and 3 (3 does not divide Nk = 4; at
    Nk = 1 every chunk is shorter than the plane prime of 2) and row
    tiles of 1, 3 and the default: every owned step and every
    accumulator partial is written (the outputs start as NaN) and agrees
    with the plain interpreter."""
    dims = dict(DIM, k=nk)
    ref = compile_program(ALL_PROGRAMS[name](), backend="interp_torch",
                          device="cpu")
    arrs = _arrays(ref.kernel_plan, np.random.default_rng(nk), dims)
    want = ref.fn(**arrs)
    before = k1.launches
    got = compile_program(ALL_PROGRAMS[name](), backend=emulator,
                          device="cpu", chunk=chunk,
                          plane_chunk=plane_chunk).fn(**arrs)
    assert k1.launches == before + 1
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   atol=2e-4, rtol=1e-3,
                                   err_msg=f"{name}/{nk}/{chunk}/{plane_chunk}")


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(ALL_PROGRAMS))
def test_cuda_kernel_matches_plain_interpreter_on_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (run on the GPU)")
    ref = compile_program(ALL_PROGRAMS[name](), backend="interp_torch",
                          device="cuda")
    arrs = _arrays(ref.kernel_plan, np.random.default_rng(5))
    want = ref.fn(**arrs)
    before = k1.launches
    for chunk in (2, None):
        got = compile_program(ALL_PROGRAMS[name](), device="cuda",
                              chunk=chunk).fn(**arrs)
        for k in want:
            torch.testing.assert_close(got[k], want[k], atol=2e-4,
                                       rtol=1e-3)
    assert k1.launches > before
