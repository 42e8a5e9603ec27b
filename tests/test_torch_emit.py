"""The CUDA emitter: kernel bodies lower to C deterministically, every
plan's source is stable, and the emitted kernels compute what the plain
interpreter computes.

Three legs:

* the tracer, on every program's bodies (float literals carry an ``f``
  suffix; unsupported operations raise when the source is emitted);
* the emitted ``.cu`` of every golden plan, identical on two runs;
* the emitted kernels compiled as host C++ (``-DHFAV_EMULATE``: blocks
  one after another, a block's threads as host threads meeting at a
  barrier in ``__syncthreads``, ``cp.async`` deferred to the wait that
  retires it; ``tests/_emulate.py``'s emulated ``"cuda"`` interpreter,
  outputs seated as on the card) and held against ``interp_torch`` with
  small forced row chunks, which tests the kernels' slot, clamp, chunk,
  priming, ring and ownership logic and the device fold of accumulator
  partials without a GPU;
* the row step's barriers, checked against a hazard analysis of each
  call's step reads and writes (``tests/_emulate.py``'s), apart from the
  emitter's;
* the launch chooser at a given residency;

plus the on-card cases, which need a CUDA device and ``nvcc`` and skip
without one.
"""
import json
import re
import subprocess

import numpy as np
import pytest
import torch

from _emulate import DIM, _arrays, _plan, check_barriers, host_build
from _emulate import emulator  # noqa: F401 (the emulated K1)
from _goldens import golden_path
from repro_torch.core import (ALL_PROGRAMS, PlanUnsupported,
                              compile_program, from_reference_dict)
from repro_torch.core.plan import acc_init_wrap
from repro_torch.kernels.stencil2d import kernel as k1
from repro_torch.kernels.stencil2d.emit import (COLS_PER_THREAD, CallLayout,
                                                LoweringError, c_float,
                                                emit_source, lower_body)


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
        json.loads(golden_path(name).read_text()))
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
    run = norm.concretize((4096, 2048), 2)
    assert run.nblocks >= 132 and run.nchunks == run.nblocks
    assert norm.concretize((4096, 2048), 2, chunk=8).nchunks == 512
    heat = CallLayout(_plan("advect4d_halo").calls[0])
    assert heat.planar and heat.seq_dims == [1] and heat.indep_dims == [0]
    assert heat.pdim == 1 and heat.walk_dims == []
    # u[k-1], u[k+1]: two planes behind the streamed one; rows at j only
    assert (heat.pprime, heat.prime) == (2, 0)
    run = heat.concretize((3, 5, 37, 200), 8, chunk=3, plane_chunk=2)
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
    run = lay.concretize(sizes, 4)
    assert run.nblocks >= 132
    # the global scratch holds only the accumulators' partial rows
    assert 0 < run.smem_bytes <= 232448
    assert dict(zip(lay.int_names, run.ints))["use_smem"] == 1
    assert (run.scratch_floats == 0) == (not lay.acc_outs)
    assert run.nchunks > 1


def test_chooser_fills_waves_from_the_given_residency():
    """At 4 blocks an SM, cosmo at 64 x 512 x 512 takes one wave (the
    chooser's scoring: 64-row chunks, 512 blocks); at 2 and 1 blocks an
    SM normalization and hydro1d take the fewest waves their blocks
    allow; the residency function is asked at each candidate's threads
    and shared memory, and the launch holds its answer."""
    cosmo = CallLayout(_plan("cosmo").calls[0])
    run = cosmo.concretize((64, 512, 512), 4)
    assert run.threads * COLS_PER_THREAD == 512 and run.resident == 4
    assert run.waves == 1 and run.nblocks == 512 and run.chunk_len == 64
    for name, sizes, per_sm in (("normalization", (4096, 2048), 2),
                                ("hydro1d", (2048, 4096), 1)):
        for call in _plan(name).calls:
            if not call.has_grid:
                continue
            run = CallLayout(call).concretize(sizes, per_sm)
            assert run.resident == per_sm
            assert run.waves == -(-run.nblocks // (132 * per_sm)) == 1
            assert run.nblocks > 132 * per_sm // 2
    asked = []

    def resident(threads, smem_bytes):
        asked.append((threads, smem_bytes))
        return 4 if smem_bytes < 64 * 1024 else 1

    run = cosmo.concretize((64, 512, 512), resident)
    assert asked and all(t * COLS_PER_THREAD == 512 and 0 < b <= 232448
                         for t, b in asked)
    assert run.resident == resident(run.threads, run.smem_bytes)


# ---------------------------------------------------------------------------
# The row step's barriers, against a hazard analysis of its own
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(ALL_PROGRAMS))
def test_row_step_barriers_cover_every_hazard(name):
    for call in _plan(name).calls:
        if call.has_grid:
            check_barriers(call)


def test_hydro1d_row_step_drops_barriers():
    """hydro1d's seven bodies met 9 barriers a row step (one after the
    copies, one after each body, one after the accumulators); its i +- 1
    reads need 3 between phases, plus the one after the ring's wait."""
    call = next(c for c in _plan("hydro1d").calls if c.has_grid)
    assert check_barriers(call) == 4 < 9
    lay = CallLayout(call)
    assert lay.reg_locals == {"slope_rho", "qstar_rho"}
    assert ("local", "slope_rho") not in lay.fast


# ---------------------------------------------------------------------------
# The emitted kernels, compiled as host C++
# ---------------------------------------------------------------------------

def test_emulated_cp_async_is_deferred():
    """The emulation's cp.async writes NaNs at issue and the data only at
    the wait_group that retires its group."""
    exe = host_build(
        '#include "emulate.h"\n#include <cmath>\n#include <cstdio>\n'
        "int main() {\n"
        "  alignas(16) float src[8] = {1, 2, 3, 4, 5, 6, 7, 8};\n"
        "  alignas(16) float dst[8] = {0, 0, 0, 0, 0, 0, 0, 0};\n"
        "  hfav_cp_async16(dst, src, 16);\n"
        "  hfav_cp_async_commit();\n"
        "  hfav_cp_async4(dst + 4, src + 4);\n"
        "  hfav_cp_async_commit();\n"
        "  const bool nan_before = std::isnan(dst[0]) && std::isnan(dst[4]);\n"
        "  hfav_cp_async_wait(1);\n"
        "  const bool first = dst[3] == 4 && std::isnan(dst[4]);\n"
        "  hfav_cp_async_wait(0);\n"
        '  std::printf("%d %d %d\\n", nan_before, first, dst[4] == 5);\n'
        "}\n", program=True)
    assert subprocess.run([str(exe)], capture_output=True,
                          text=True).stdout.split() == ["1", "1", "1"]


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


@pytest.mark.parametrize("name", sorted(ALL_PROGRAMS))
def test_emulated_kernel_from_global_scratch(name, emulator, monkeypatch):
    """With a shared-memory limit no region fits, every block keeps its
    windows in global scratch (the launch of a region over the card's
    227 KB) and still agrees with the plain interpreter."""
    from repro_torch.kernels.stencil2d import emit
    monkeypatch.setattr(emit, "SMEM_LIMIT", 4)
    ref = compile_program(ALL_PROGRAMS[name](), backend="interp_torch",
                          device="cpu")
    arrs = _arrays(ref.kernel_plan, np.random.default_rng(6))
    want = ref.fn(**arrs)
    runs = []
    real = CallLayout.concretize

    def recorded(self, *a, **k):
        runs.append(real(self, *a, **k))
        return runs[-1]

    monkeypatch.setattr(CallLayout, "concretize", recorded)
    for chunk in (2, None):
        got = compile_program(ALL_PROGRAMS[name](), backend=emulator,
                              device="cpu", chunk=chunk,
                              use_cache=False).fn(**arrs)
        for k in want:
            np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                       atol=2e-4, rtol=1e-3,
                                       err_msg=f"{name}/chunk={chunk}:{k}")
    assert runs and all(r.smem_bytes == 0 for r in runs)


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


@pytest.mark.parametrize("name,dims,opts", [
    ("normalization", dict(DIM, j=40), {"chunk": 1}),
    ("normalization", dict(DIM, j=64), {"chunk": 1}),
    ("heat3d_residual_norm", dict(DIM, k=5, j=9), {"chunk": 1,
                                                   "plane_chunk": 1}),
    ("heat3d_residual_norm", dict(DIM, k=4, j=8), {"chunk": 1,
                                                   "plane_chunk": 1}),
    ("plane_sum", dict(DIM, j=11), {"chunk": 1})])
def test_emulated_device_fold_matches_plain_and_repeats(name, dims, opts,
                                                        emulator):
    """The accumulators folded on the device agree with the plain
    interpreter, and two launches give the same bits: 40 and 45 partial
    rows (one block folds them, in three passes), 64 and 32 (in groups
    of 16, then the groups), and a kept accumulator (a row per outer
    tile, 11 partials each)."""
    ref = compile_program(ALL_PROGRAMS[name](), backend="interp_torch",
                          device="cpu")
    arrs = _arrays(ref.kernel_plan, np.random.default_rng(3), dims)
    want = ref.fn(**arrs)
    gen = compile_program(ALL_PROGRAMS[name](), backend=emulator,
                          device="cpu", **opts)
    got, again = gen.fn(**arrs), gen.fn(**arrs)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   atol=2e-4, rtol=1e-3, err_msg=k)
        assert torch.equal(got[k], again[k]), k


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
