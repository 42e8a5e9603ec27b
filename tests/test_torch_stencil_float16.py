"""The CUDA stencil kernel (K1) in float16, held to the two gates of the
bf16 tests (``tests/test_torch_stencil_bf16.py``) at float16's
precision, and the emulation's host ``__half``.

The inputs are drawn from a seed and rounded to float16; the exact value
is the same program in float64 (``interp_torch``) on those inputs; the
plain float16 versions are ``interp_torch`` in float16 and, in the CPU
tests, the reference's ``interp_jax`` in float16.

* Gate E, every output: ``rel_l2(K1, exact) <= max(1.25 * rel_l2(plain,
  exact), 2**-11)``: one float16 step where bf16's gate takes one bf16
  step.
* Gate R, every output of a program with no accumulator: K1 within
  ``atol = rtol = 2.5e-3`` (bf16's ``2e-2`` divided by 8, float16's step
  being bf16's divided by 8) of the plain version, ``atol`` times its
  largest finite magnitude.

float16's range ends at 65504, and the plain version, which rounds every
intermediate to float16, overflows first (hydro1d's pressures at these
inputs).  So K1's non-finite elements must be a subset of the plain
version's, and both gates hold over the elements where both are finite.
Both gates are held call by call and program by program as in bf16, the
accumulating programs' outputs over long sums.

The module imports no JAX at its top level: the tests that compare with
``interp_jax`` import it inside.
"""
import ctypes
import hashlib
import re
import subprocess

import numpy as np
import pytest
import torch

from _emulate import ODD_DIM as DIM
from _emulate import (ACCUMULATING, ISSUE_ROW_CPP, LONG_SUMS, SOURCES,
                      _golden, _listed, _numpy, _plan, has_accumulator,
                      host_build, recorded_calls, rel_l2)
from _emulate import emulator  # noqa: F401 (the emulated K1)
from _inputs import hydro2d_state
from repro_torch.core import ALL_PROGRAMS, compile_program
from repro_torch.core.interpreters import assemble, get_interpreter
from repro_torch.kernels.stencil2d import kernel as k1
from repro_torch.kernels.stencil2d.emit import CallLayout, emit_source

FP16_TOL = 2e-2 / 8
GATE_E_FACTOR, GATE_E_FLOOR = 1.25, 2.0 ** -11

def fp16_inputs(name, kplan, rng, dims=DIM):
    """One seeded array per axiom of ``kplan``, the draws of the bf16
    tests rounded to float16 and held as float32 (each value exact in
    both)."""
    sizes = {sym: dims.get(d, 3) for d, sym in kplan.dim_sizes}
    out = {}
    for ax in kplan.axioms:
        ext = {d: (sym, lo, hi) for d, sym, lo, hi in ax.extents}
        shape = [sizes[ext[d][0]] + ext[d][2] - ext[d][1] for d in ax.dims]
        a = rng.standard_normal(shape).astype(np.float32)
        if name == "hydro1d" and ax.array == "rho":
            a = a * a + 1.0
        a = hydro2d_state(name, ax.array, a)
        out[ax.array] = torch.from_numpy(a).half().float().numpy()
    return out


def both_finite(got, plain, tag: str) -> np.ndarray:
    """The elements where K1 and the plain version are both finite;
    raises where K1 is not finite and the plain version is."""
    g, p = np.isfinite(got), np.isfinite(plain)
    assert not (p & ~g).any(), (
        f"{tag}: {int((p & ~g).sum())} elements non-finite in K1 and "
        f"finite in the plain float16 version")
    return g & p


def gate_e(got: dict, plain: dict, exact: dict, tag: str) -> dict:
    """Gate E on every output, over the elements where K1 and the plain
    version are finite; returns ``{output: (K1's rel. L2, the plain
    version's)}`` to the exact value."""
    out = {}
    for k, e in exact.items():
        assert np.isfinite(np.asarray(e)).all(), f"{tag}:{k}: exact value"
        g, p = np.asarray(got[k]), np.asarray(plain[k])
        m = both_finite(g, p, f"{tag}:{k}")
        mine, theirs = rel_l2(g[m], e[m]), rel_l2(p[m], e[m])
        assert mine <= max(GATE_E_FACTOR * theirs, GATE_E_FLOOR), (
            f"{tag}:{k}: K1 float16 rel. L2 {mine:.3e} to the exact value, "
            f"the plain float16 {theirs:.3e}")
        out[k] = (mine, theirs)
    return out


def gate_r(got: dict, plain: dict, tag: str) -> None:
    """Gate R on every output: K1 within the float16 tolerance of the
    plain version where both are finite."""
    for k, p in plain.items():
        p = np.array(p, dtype=np.float32)
        g = np.array(got[k], dtype=np.float32)
        m = both_finite(g, p, f"{tag}:{k}")
        scale = max(float(np.abs(p[m]).max(initial=0.0)), 1.0)
        np.testing.assert_allclose(g[m], p[m], atol=FP16_TOL * scale,
                                   rtol=FP16_TOL, err_msg=f"{tag}:{k}")


def call_gates(calls, tag: str) -> None:
    """Gates E and R on each recorded K1 call: its outputs (accumulator
    rows before the lane fold) against ``interp_torch``'s call on the
    same inputs, in float16 and (the exact value) in float64."""
    plain = get_interpreter("interp_torch")
    assert calls
    for lay, run, args, outs in calls:
        call = lay.call
        *outer, nj, ni = run.sizes

        def values(outs, seated=()):
            # a seated output is its goal already
            return {o.name: (p if k in seated else assemble(
                        call, o, p, nj, ni, tuple(outer), lanes=True)
                    ).float().cpu().numpy()
                    for k, (o, p) in enumerate(zip(call.outputs, outs))}
        fn, _ = plain.build_call(call, run.sizes, torch.float16,
                                 device=args[0].device)
        fn64, _ = plain.build_call(call, run.sizes, torch.float64,
                                   device=args[0].device)
        got = values(outs, lay.seated_outs)
        want = values(_listed(fn(*args)))
        exact = values(_listed(fn64(*[a.double() for a in args])))
        gate_e(got, want, exact, f"{tag}/{call.name}")
        if not call.accs:
            gate_r(got, want, f"{tag}/{call.name}")


# ---------------------------------------------------------------------------
# The sources
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(SOURCES["bfloat16"]))
def test_bf16_sources_are_unchanged(name):
    h = hashlib.sha256()
    for call in _golden(name).calls:
        if call.has_grid:
            h.update(emit_source(call, torch.bfloat16).encode())
    assert h.hexdigest()[:16] == SOURCES["bfloat16"][name]


@pytest.mark.parametrize("name", sorted(ALL_PROGRAMS))
def test_float16_sources_store_half_and_compute_in_float(name):
    """A float16 source is the bf16 source with ``__half`` for
    ``__nv_bfloat16`` and float16's conversions for bf16's: windows and
    rows ``__half``, a conversion at each load and store; accumulators,
    locals and bodies float."""
    for call in _golden(name).calls:
        if not call.has_grid:
            continue
        src = emit_source(call, torch.float16)
        assert src == emit_source(call, "float16")
        assert "hfav::Params<HFAV_NP, HFAV_ND, __half> P" in src
        assert "__half2float(" in src and "bfloat16" not in src
        if any(o.acc is None for o in call.outputs):
            assert "__float2half_rn(" in src
        assert "hfav::cap8(" in src and "hfav::cap4(" not in src
        for a in call.accs:  # float, in the region's own words
            assert re.search(rf"\n  float\* const f\d+_{a.name} = fast ",
                             src), a.name
        bf16 = emit_source(call, torch.bfloat16)
        assert src == bf16.replace("__nv_bfloat16", "__half").replace(
            "__bfloat162float", "__half2float").replace(
            "__float2bfloat16_rn", "__float2half_rn")


def test_float16_layout_is_bf16s():
    """float16 takes 2 bytes an element, as bf16: the same ring rows,
    shared memory and launch at every size."""
    for name in ("cosmo", "normalization", "heat3d"):
        call = next(c for c in _plan(name).calls if c.has_grid)
        bf, fp = CallLayout(call, torch.bfloat16), CallLayout(call,
                                                               torch.float16)
        assert (fp.itemsize, fp.dtype) == (2, "float16")
        sizes = (64, 512, 512) if call.n_outer else (4096, 2048)
        a, b = bf.concretize(sizes, 4), fp.concretize(sizes, 4)
        assert (a.ints, a.smem_bytes, a.nblocks) == (b.ints, b.smem_bytes,
                                                     b.nblocks)


# ---------------------------------------------------------------------------
# The host __half of emulate.h, and the float16 ring copy of one row
# ---------------------------------------------------------------------------

HALF_CPP = r"""
#include "emulate.h"
extern "C" void to_float(const unsigned short* h, float* f, int n) {
  for (int i = 0; i < n; ++i) f[i] = __half2float({h[i]});
}
extern "C" void to_half(const float* f, unsigned short* h, int n) {
  for (int i = 0; i < n; ++i) h[i] = __float2half_rn(f[i]).x;
}
"""


@pytest.fixture(scope="module")
def host_half():
    def bind(lib):
        for fn in (lib.to_float, lib.to_half):
            fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
    return host_build(HALF_CPP, bind=bind)


def _halves(bits: np.ndarray) -> np.ndarray:
    return torch.from_numpy(bits.view(np.int16).copy()).view(
        torch.float16).float().numpy()


def test_host_half_round_trips_every_bit_pattern(host_half):
    """All 65536 patterns: half -> float as torch reads them (NaNs as
    NaNs), and float -> half back to the same bits (NaN stays NaN)."""
    bits = np.arange(65536, dtype=np.uint16)
    f = np.zeros(65536, np.float32)
    host_half.to_float(bits.ctypes.data, f.ctypes.data, 65536)
    want = _halves(bits)
    nan = np.isnan(want)
    assert nan.sum() == 2046
    np.testing.assert_array_equal(f[~nan], want[~nan])
    assert np.isnan(f[nan]).all()
    back = np.zeros(65536, np.uint16)
    host_half.to_half(f.ctypes.data, back.ctypes.data, 65536)
    np.testing.assert_array_equal(back[~nan], bits[~nan])
    assert np.isnan(_halves(back[nan])).all()


def test_host_half_rounds_a_float_sweep_as_torch(host_half):
    """float -> half against ``torch.float16``: random magnitudes from
    1e-9 to 1e6, the midpoints of every two adjacent finite halves (ties
    to even), the subnormal and overflow edges, Inf and NaN."""
    rng = np.random.default_rng(0)
    hb = np.arange(0x7bff, dtype=np.uint16)
    mid = ((_halves(hb).astype(np.float64) + _halves(hb + 1)) / 2)
    edges = [65504, 65519.99, 65520, 65536, 1e30, np.inf, 2.0 ** -24,
             2.0 ** -25, 3 * 2.0 ** -26, 2.0 ** -25 * 1.0001, 2.0 ** -14,
             2.0 ** -14 * (1 - 2.0 ** -12), 0.0, 1.0 + 2.0 ** -11]
    v = np.concatenate([
        rng.standard_normal(100000) * 10.0 ** rng.integers(-9, 7, 100000),
        mid, edges]).astype(np.float32)
    v = np.concatenate([v, -v, [np.nan]]).astype(np.float32)
    out = np.zeros(len(v), np.uint16)
    host_half.to_half(v.ctypes.data, out.ctypes.data, len(v))
    want = torch.from_numpy(v).half().view(torch.int16).numpy().view(
        np.uint16)
    ok = ~np.isnan(v)
    np.testing.assert_array_equal(out[ok], want[ok])
    assert np.isnan(_halves(out[~ok])).all()


def test_emulated_float16_row_copy_heads_tails_and_tensor_bounds():
    """The bf16 test's row copy (rows of 1-20 values at every offset mod
    16 bytes, as a tensor's first row and a later one, under
    AddressSanitizer) for ``__half`` rows: the same template, with a
    sentinel that is no value of the row (0x4b00 is 14.0 in float16)."""
    exe = host_build(ISSUE_ROW_CPP.replace("__nv_bfloat16", "__half")
                     .replace("__float2bfloat16", "__float2half_rn")
                     .replace("__bfloat162float", "__half2float")
                     .replace("0x4b00", "0x7bff"), ("-fsanitize=address",),
                     program=True)
    run = subprocess.run([str(exe)], capture_output=True, text=True)
    assert run.returncode == 0, run.stderr[-3000:]
    assert run.stdout.split() == ["0"]


# ---------------------------------------------------------------------------
# The emitted float16 kernels, compiled as host C++
# ---------------------------------------------------------------------------

_REFS: dict = {}


def references(name, dims=DIM, seed=5):
    """(inputs, the exact value, interp_torch float16, interp_jax
    float16, plan) of program ``name`` (memoized)."""
    key = (name, tuple(sorted(dims.items())), seed)
    if key not in _REFS:
        import jax.numpy as jnp
        from repro.core import compile_program as ref_compile
        from repro.core.programs import ALL_PROGRAMS as REF_PROGRAMS

        kplan = _plan(name)
        arrs = fp16_inputs(name, kplan, np.random.default_rng(seed), dims)
        exact = compile_program(ALL_PROGRAMS[name](), backend="interp_torch",
                                dtype=torch.float64, device="cpu").fn(**arrs)
        plain = compile_program(ALL_PROGRAMS[name](), backend="interp_torch",
                                dtype=torch.float16, device="cpu").fn(**arrs)
        ref = None  # the port's own programs have no interp_jax
        if name in REF_PROGRAMS:
            jax_out = ref_compile(REF_PROGRAMS[name](), backend="interp_jax",
                                  dtype=jnp.float16).fn(**arrs)
            ref = {k: np.asarray(v.astype(jnp.float32))
                   for k, v in jax_out.items()}
        _REFS[key] = (arrs, _numpy(exact), _numpy(plain), ref, kplan)
    return _REFS[key]


def _check(name, run, tag, dims=DIM, programs=None):
    """``run()`` (program ``name`` through the emulated K1) held to the
    gates: call by call, and program by program for a program without an
    accumulator (or ``programs=True``: Gate E on every output)."""
    arrs, exact, plain, ref, kplan = references(name, dims)
    for k, e in exact.items():
        assert np.abs(e).max() > 0, f"{tag}:{k}: the exact value is zero"
    with recorded_calls() as calls:
        got = run(arrs)
    assert set(got) == set(exact)
    for k, v in got.items():
        assert v.dtype == torch.float16, k
    call_gates(calls, tag)
    got = _numpy(got)
    if programs is None:
        programs = not has_accumulator(kplan)
    if programs:
        gate_e(got, plain, exact, f"{tag} vs interp_torch")
        if ref is not None:
            gate_e(got, ref, exact, f"{tag} vs interp_jax")
    if not has_accumulator(kplan):
        gate_r(got, plain, f"{tag} vs interp_torch")
        if ref is not None:
            gate_r(got, ref, f"{tag} vs interp_jax")


def _through(emulator, name, **opts):
    return lambda arrs: compile_program(
        ALL_PROGRAMS[name](), backend=emulator, dtype=torch.float16,
        device="cpu", **opts).fn(**arrs)


@pytest.mark.parametrize("chunk", [1, 2, None])
@pytest.mark.parametrize("name", sorted(ALL_PROGRAMS))
def test_emulated_float16_kernel_gates(name, chunk, emulator):
    """Every program's emulated float16 K1 against the exact value and
    the plain float16 versions, with row chunks of 1, 2 and the
    default."""
    before = k1.launches
    _check(name, _through(emulator, name, chunk=chunk),
           f"{name}/chunk={chunk}")
    assert k1.launches > before


@pytest.mark.parametrize("name", ACCUMULATING)
def test_emulated_float16_long_sums(name, emulator):
    """Every program with an accumulator, over 512 rows: Gate E on its
    program outputs against both plain versions, whose float16
    accumulator rows lose bits there."""
    _check(name, _through(emulator, name), f"{name}/long", LONG_SUMS,
           programs=True)


@pytest.mark.parametrize("name", ["heat3d_residual_norm", "advect4d_halo"])
def test_emulated_float16_plane_chunks(name, emulator):
    """Plane-window calls in float16 in plane chunks of 1 and 3 (3 does
    not divide Nk = 4) times row tiles of 1 and 3."""
    for chunk, plane_chunk in ((1, 1), (3, 3)):
        _check(name, _through(emulator, name, chunk=chunk,
                              plane_chunk=plane_chunk),
               f"{name}/{chunk}x{plane_chunk}")


def test_emulated_float16_from_global_scratch(emulator, monkeypatch):
    """With no room in shared memory, float16 windows in the global
    scratch (plain loads and stores) pass the gates too."""
    from repro_torch.kernels.stencil2d import emit
    monkeypatch.setattr(emit, "SMEM_LIMIT", 4)
    for name in ("hydro1d", "heat3d_stage", "normalization"):
        _check(name, _through(emulator, name, chunk=2, use_cache=False),
               f"{name}/global scratch")


def test_emulated_float16_odd_rows_with_one_column_halo(emulator):
    """At odd Ni every other row of laplace5's and normalization's inputs
    starts between two 4-byte words and ends between two: the copies
    take their 2-byte heads and tails."""
    dims = dict(DIM, i=21, j=6)
    for name in ("laplace5", "normalization"):
        _check(name, _through(emulator, name, chunk=1), f"{name}/odd",
               dims)


def test_emulated_float16_overflow_is_the_plain_versions(emulator):
    """hydro1d at the reference's conformance draws (``arrays_for``: seed
    3, 7 x 20, the density not kept positive), where float32 reaches 4354
    and the plain float16 version, rounding every intermediate, passes
    65504 on two elements, as the reference's does: K1 (float
    arithmetic, one rounding) stays finite there, and both gates hold
    over the rest."""
    kplan = _plan("hydro1d")
    rng = np.random.default_rng(3)
    sizes = {sym: {"i": 20, "j": 7}[d] for d, sym in kplan.dim_sizes}
    arrs = {}
    for ax in kplan.axioms:
        ext = {d: (sym, lo, hi) for d, sym, lo, hi in ax.extents}
        shape = [sizes[ext[d][0]] + ext[d][2] - ext[d][1] for d in ax.dims]
        arrs[ax.array] = torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).half().float().numpy()
    plain, exact = (_numpy(compile_program(
        ALL_PROGRAMS["hydro1d"](), backend="interp_torch", dtype=dt,
        device="cpu").fn(**arrs)) for dt in (torch.float16, torch.float64))
    with recorded_calls() as calls:
        got = _numpy(_through(emulator, "hydro1d")(arrs))
    assert sum(int((~np.isfinite(v)).sum()) for v in plain.values()) == 2
    assert all(np.isfinite(v).all() for v in got.values())
    call_gates(calls, "hydro1d/overflow")
    gate_e(got, plain, exact, "hydro1d/overflow")
    gate_r(got, plain, "hydro1d/overflow")


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(ALL_PROGRAMS))
def test_cuda_float16_kernel_gates_on_card(name):
    """The float16 twin of ``test_cuda_bf16_kernel_gates_on_card``: K1 in
    float16 (``backend="cuda"`` and ``"auto"``) against ``interp_torch``
    in float16 and float64 on the card, Gates E and R as on the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (run on the GPU)")
    kplan = _plan(name)

    def run(backend, dims, **opts):
        arrs = fp16_inputs(name, kplan, np.random.default_rng(5), dims)
        exact, plain = (_numpy(compile_program(
            ALL_PROGRAMS[name](), backend="interp_torch", dtype=dt,
            device="cuda").fn(**arrs)) for dt in (torch.float64,
                                                  torch.float16))
        gen = compile_program(ALL_PROGRAMS[name](), backend=backend,
                              dtype=torch.float16, device="cuda", **opts)
        assert gen.interpreter == "cuda"
        with recorded_calls() as calls:
            got = gen.fn(**arrs)
        for k, v in got.items():
            assert v.dtype == torch.float16 and v.is_cuda, k
        return _numpy(got), plain, exact, calls

    before = k1.launches
    for backend, chunk in (("cuda", 2), ("cuda", None), ("auto", None)):
        tag = f"{name}/{backend}/{chunk}"
        got, plain, exact, calls = run(backend, DIM, chunk=chunk)
        call_gates(calls, tag)
        if not has_accumulator(kplan):
            gate_e(got, plain, exact, tag)
            gate_r(got, plain, tag)
    if has_accumulator(kplan):
        got, plain, exact, _ = run("cuda", LONG_SUMS)
        assert all(np.abs(e).max() > 0 for e in exact.values())
        gate_e(got, plain, exact, f"{name}/long")
    assert k1.launches > before
