"""The CUDA stencil kernel (K1) in bf16, held to two gates against the
exact value.

The inputs are drawn from a seed and rounded to bf16.  The exact value
(``f64``) is the same program in float64 (``interp_torch``) on those
inputs; the plain bf16 versions are ``interp_torch`` in bf16 and, in the
CPU tests, the reference's ``interp_jax`` in bf16.

* Gate E, every output of every program: ``rel_l2(K1, f64) <=
  max(1.25 * rel_l2(plain, f64), 2**-8)``.  K1 may be more accurate than
  the plain versions, not less accurate by more than a quarter or than
  one bf16 step.
* Gate R, every output of a program with no accumulator: K1 lies within
  the repository's bf16 tolerance of the plain version (``atol = rtol =
  2e-2``, ``atol`` times ``max(max|plain|, 1)``:
  ``tests/test_torch_interp_bf16.py``).

Both gates hold at two levels.  Call by call, every K1 call's outputs
(an accumulator's rows before the host folds their lanes) against the
plain interpreter's call on the same inputs, and the exact value of that
call: every program, every chunking.  Program by program, every output
of every program without an accumulator.  A program with an accumulator
is held by Gate E alone: the plain versions keep the accumulator row in
bf16 and round it at every row, while K1 sums in float32 and rounds once
(``csrc/stencil2d.cuh``), so the two part by more than a bf16 tolerance
on long sums, K1 being the closer to the exact value.  Its program
outputs are held to Gate E over long sums (512 rows), where the plain
accumulator stagnates: over a few rows the two accumulators round the
same few values and the host then folds the lanes and takes roots in
bf16 for both, so which lands nearer the exact value is chance: on a
single draw either may, by a bf16 rounding of the folded sum.

The CPU tests compile the emitted bf16 kernels as host C++ (``g++
-DHFAV_EMULATE``: the emulated ``"cuda"`` interpreter of
``tests/_emulate.py``, its outputs seated as on the card); the
``cuda``-marked twin runs the built kernel on the card.  The module
imports no JAX at its top level (the card's machine has none): the tests
that compare with ``interp_jax`` import it inside.
"""
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
from repro_torch.core import ALL_PROGRAMS, PlanUnsupported, compile_program
from repro_torch.core.interpreters import assemble, get_interpreter
from repro_torch.kernels.stencil2d import kernel as k1
from repro_torch.kernels.stencil2d.emit import (CallLayout, cap4,
                                                emit_source)

BF16_TOL = 2e-2
#: Gate E: K1's relative L2 error to the exact value may exceed the
#: plain version's by this factor, or reach one bf16 step.
GATE_E_FACTOR, GATE_E_FLOOR = 1.25, 2.0 ** -8

def bf16_inputs(name, kplan, rng, dims=DIM):
    """One seeded array per axiom of ``kplan``, rounded to bf16 and held
    as float32 (each value exact in both); hydro1d's density positive,
    as in the repository's hydro benchmark."""
    sizes = {sym: dims.get(d, 3) for d, sym in kplan.dim_sizes}
    out = {}
    for ax in kplan.axioms:
        ext = {d: (sym, lo, hi) for d, sym, lo, hi in ax.extents}
        shape = [sizes[ext[d][0]] + ext[d][2] - ext[d][1] for d in ax.dims]
        a = rng.standard_normal(shape).astype(np.float32)
        if name == "hydro1d" and ax.array == "rho":
            a = a * a + 1.0
        a = hydro2d_state(name, ax.array, a)
        out[ax.array] = torch.from_numpy(a).bfloat16().float().numpy()
    return out


def gate_e(got: dict, plain: dict, exact: dict, tag: str) -> dict:
    """Gate E on every output; returns ``{output: (K1's rel. L2, the
    plain version's)}`` to the exact value."""
    out = {}
    for k, e in exact.items():
        assert np.isfinite(np.asarray(e)).all(), f"{tag}:{k}: exact value"
        mine, theirs = rel_l2(got[k], e), rel_l2(plain[k], e)
        assert mine <= max(GATE_E_FACTOR * theirs, GATE_E_FLOOR), (
            f"{tag}:{k}: K1 bf16 rel. L2 {mine:.3e} to the exact value, "
            f"the plain bf16 {theirs:.3e}")
        out[k] = (mine, theirs)
    return out


def gate_r(got: dict, plain: dict, tag: str) -> None:
    """Gate R on every output: K1 within the bf16 tolerance of the plain
    version."""
    for k, p in plain.items():
        p = np.array(p, dtype=np.float32)
        g = np.array(got[k], dtype=np.float32)
        scale = max(float(np.abs(p).max()), 1.0)
        np.testing.assert_allclose(g, p, atol=BF16_TOL * scale,
                                   rtol=BF16_TOL, err_msg=f"{tag}:{k}")


def call_gates(calls, tag: str) -> None:
    """Gates E and R on each recorded K1 call: its outputs (accumulator
    rows before the lane fold) against ``interp_torch``'s call on the
    same inputs, in bf16 and (the exact value) in float64."""
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
        fn, _ = plain.build_call(call, run.sizes, torch.bfloat16,
                                 device=args[0].device)
        fn64, _ = plain.build_call(call, run.sizes, torch.float64,
                                   device=args[0].device)
        got = values(outs, lay.seated_outs)
        want = values(_listed(fn(*args)))
        exact = values(_listed(fn64(*[a.double() for a in args])))
        for v in got.values():
            assert np.isfinite(v).all(), f"{tag}/{call.name}"
        gate_e(got, want, exact, f"{tag}/{call.name}")
        if not call.accs:
            gate_r(got, want, f"{tag}/{call.name}")


# ---------------------------------------------------------------------------
# Declared dtypes, and the float32 sources
# ---------------------------------------------------------------------------

def test_cuda_declares_float32_and_bf16_and_refuses_the_rest():
    """K1 builds for float32, bf16 and float16 (the reference's kernel
    takes any float dtype) and refuses float64, which no TPU kernel of
    the reference runs."""
    assert get_interpreter("cuda").dtypes == {torch.float32, torch.bfloat16,
                                              torch.float16}
    call = next(c for c in _plan("laplace5").calls if c.has_grid)
    assert "__half" in emit_source(call, torch.float16)
    k1.build_call(call, (9, 37), torch.float16)  # builds at the first call
    dt = torch.float64
    with pytest.raises(PlanUnsupported, match="float64"):
        k1.build_call(call, (9, 37), dt)
    with pytest.raises(PlanUnsupported, match="float64"):
        compile_program(ALL_PROGRAMS["laplace5"](), backend="cuda",
                        dtype=dt, device="cpu")
    with pytest.raises(PlanUnsupported, match="float64"):
        emit_source(call, dt)


@pytest.mark.parametrize("name", sorted(SOURCES["float32"]))
def test_float32_sources_are_unchanged(name):
    h = hashlib.sha256()
    for call in _golden(name).calls:
        if call.has_grid:
            src = emit_source(call)
            assert src == emit_source(call, torch.float32)
            h.update(src.encode())
    assert h.hexdigest()[:16] == SOURCES["float32"][name]


@pytest.mark.parametrize("name", sorted(ALL_PROGRAMS))
def test_bf16_sources_store_bf16_and_compute_in_float(name):
    """A bf16 source types its windows and rows bf16 and converts at
    each load and store; accumulators, locals and bodies stay float."""
    for call in _golden(name).calls:
        if not call.has_grid:
            continue
        src = emit_source(call, torch.bfloat16)
        assert src == emit_source(call, "bfloat16")
        assert "hfav::Params<HFAV_NP, HFAV_ND, __nv_bfloat16> P" in src
        assert "__bfloat162float(" in src
        # a row output is rounded where it is stored (an accumulator in
        # the header's fold)
        if any(o.acc is None for o in call.outputs):
            assert "__float2bfloat16_rn(" in src
        assert "hfav::cap8(" in src and "hfav::cap4(" not in src
        assert "const float* const src" not in src
        assert "float* const gscratch = reinterpret_cast<float*>" in src
        for a in call.accs:  # float, in the region's own words
            assert re.search(rf"\n  float\* const f\d+_{a.name} = fast ",
                             src), a.name


def test_bf16_layout_counts_two_bytes_an_element():
    """The ring rows of a bf16 window take 8-element (16-byte) granules
    and half the bytes; float locals and accumulators keep 4 bytes."""
    assert [cap4(n) for n in (1, 4, 5, 37)] == [4, 8, 8, 40]
    assert [cap4(n, 2) for n in (1, 8, 9, 37)] == [8, 16, 16, 48]
    call = next(c for c in _plan("cosmo").calls if c.has_grid)
    f32, bf = CallLayout(call), CallLayout(call, torch.bfloat16)
    assert (f32.itemsize, bf.itemsize) == (4, 2)
    win, rows = ("win", f"in_{f32.row_ins[0].name}"), f32.row_ins[0].stages
    for ring in (2, 5):
        assert f32._floats(*win, 512, 0, ring, 0) == (rows + ring) * 516
        assert bf._floats(*win, 512, 0, ring, 0) == (rows + ring) * 520 // 2
    a = f32.concretize((64, 512, 512), 4, chunk=64)
    b = bf.concretize((64, 512, 512), 4, chunk=64)
    # half the bytes a row: the ring goes at least as far ahead, in less
    # shared memory
    ring = f32.int_names.index("ring")
    assert b.ints[ring] >= a.ints[ring] and b.smem_bytes < a.smem_bytes
    norm = next(c for c in _plan("normalization").calls if c.has_grid)
    acc = ("acc", norm.accs[0].name)
    for lay in (CallLayout(norm), CallLayout(norm, torch.bfloat16)):
        assert lay._floats(*acc, 100, 0, 2, 0) == 100 + norm.accs[0].w_off


# ---------------------------------------------------------------------------
# The bf16 ring copy of one row
# ---------------------------------------------------------------------------

def test_emulated_bf16_row_copy_heads_tails_and_tensor_bounds():
    """``issue_row`` for bf16 rows of 1-20 values at every offset mod 16
    bytes, as a tensor's first row and as a later one: after the wait the
    window holds the row, before it every copied element is undefined
    (the emulated ``cp.async`` defers), nothing lands outside the row and
    its two margin elements, and no copy reads outside the tensor (before
    it: a sentinel; past its end: AddressSanitizer, the tensor ending
    where its allocation does)."""
    exe = host_build(ISSUE_ROW_CPP, ("-fsanitize=address",), program=True)
    run = subprocess.run([str(exe)], capture_output=True, text=True)
    assert run.returncode == 0, run.stderr[-3000:]
    assert run.stdout.split() == ["0"]


_REFS: dict = {}


def references(name, dims=DIM, seed=5):
    """(inputs, the exact value, interp_torch bf16, interp_jax bf16) of
    program ``name`` (memoized)."""
    key = (name, tuple(sorted(dims.items())), seed)
    if key not in _REFS:
        import jax.numpy as jnp
        from repro.core import compile_program as ref_compile
        from repro.core.programs import ALL_PROGRAMS as REF_PROGRAMS

        kplan = _plan(name)
        arrs = bf16_inputs(name, kplan, np.random.default_rng(seed), dims)
        exact = compile_program(ALL_PROGRAMS[name](), backend="interp_torch",
                                dtype=torch.float64, device="cpu").fn(**arrs)
        plain = compile_program(ALL_PROGRAMS[name](), backend="interp_torch",
                                dtype=torch.bfloat16, device="cpu").fn(**arrs)
        ref = None  # the port's own programs have no interp_jax
        if name in REF_PROGRAMS:
            jax_out = ref_compile(REF_PROGRAMS[name](), backend="interp_jax",
                                  dtype=jnp.bfloat16).fn(**arrs)
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
        assert v.dtype == torch.bfloat16, k
        assert torch.isfinite(v.float()).all(), f"{tag}:{k}"
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
        ALL_PROGRAMS[name](), backend=emulator, dtype=torch.bfloat16,
        device="cpu", **opts).fn(**arrs)


@pytest.mark.parametrize("chunk", [1, 2, None])
@pytest.mark.parametrize("name", sorted(ALL_PROGRAMS))
def test_emulated_bf16_kernel_gates(name, chunk, emulator):
    """Every program's emulated bf16 K1 against the exact value and the
    plain bf16 versions, with row chunks of 1, 2 and the default."""
    before = k1.launches
    _check(name, _through(emulator, name, chunk=chunk),
           f"{name}/chunk={chunk}")
    assert k1.launches > before


def test_accumulating_programs_are_listed():
    assert ACCUMULATING == tuple(
        n for n in sorted(ALL_PROGRAMS) if has_accumulator(_plan(n)))


@pytest.mark.parametrize("name", ACCUMULATING)
def test_emulated_bf16_long_sums(name, emulator):
    """Every program with an accumulator, over 512 rows: Gate E on its
    program outputs against both plain versions, whose bf16 accumulator
    rows stagnate there."""
    _check(name, _through(emulator, name), f"{name}/long", LONG_SUMS,
           programs=True)


@pytest.mark.parametrize("name", ["heat3d_residual_norm", "advect4d_halo"])
def test_emulated_bf16_plane_chunks(name, emulator):
    """Plane-window calls in bf16 in plane chunks of 1 and 3 (3 does not
    divide Nk = 4) times row tiles of 1 and 3."""
    for chunk, plane_chunk in ((1, 1), (3, 3)):
        _check(name, _through(emulator, name, chunk=chunk,
                              plane_chunk=plane_chunk),
               f"{name}/{chunk}x{plane_chunk}")


def test_emulated_bf16_from_global_scratch(emulator, monkeypatch):
    """With no room in shared memory, bf16 windows in the global scratch
    (plain loads and stores) pass the gates too."""
    from repro_torch.kernels.stencil2d import emit
    monkeypatch.setattr(emit, "SMEM_LIMIT", 4)
    for name in ("hydro1d", "heat3d_stage", "normalization"):
        _check(name, _through(emulator, name, chunk=2, use_cache=False),
               f"{name}/global scratch")


def test_emulated_bf16_odd_rows_with_one_column_halo(emulator):
    """laplace5 reads its cell at i - 1 and i + 1 (a one-column halo) and
    normalization's flux row is one narrower than its input; at odd Ni
    every other row of each input starts between two 4-byte words and
    ends between two, the copies taking their 2-byte heads and tails."""
    dims = dict(DIM, i=21, j=6)
    for name in ("laplace5", "normalization"):
        kplan = _plan(name)
        call = next(c for c in kplan.calls if c.has_grid)
        cols = {rd.col0 for s in call.steps for rd in s.reads
                if rd.src.startswith("in_")}
        widths = {21 + i.i_hi - i.i_lo for i in call.inputs if not i.scalar}
        assert any(w % 2 for w in widths)
        if name == "laplace5":
            assert {0, 2} <= cols
        _check(name, _through(emulator, name, chunk=1), f"{name}/odd",
               dims)


def test_emulated_bf16_and_float32_launch_counts_and_repeat(emulator):
    """Two launches give the same bits (the fold's order is fixed), and a
    float32 call beside it still runs the float32 kernel."""
    arrs = references("normalization")[0]
    gen = compile_program(ALL_PROGRAMS["normalization"](), backend=emulator,
                          dtype=torch.bfloat16, device="cpu", chunk=1)
    a, b = gen.fn(**arrs), gen.fn(**arrs)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    f32 = compile_program(ALL_PROGRAMS["normalization"](), backend=emulator,
                          device="cpu", chunk=1).fn(**arrs)
    want = compile_program(ALL_PROGRAMS["normalization"](),
                           backend="interp_torch", device="cpu").fn(**arrs)
    for k in want:
        assert f32[k].dtype == torch.float32
        np.testing.assert_allclose(f32[k].numpy(), want[k].numpy(),
                                   atol=2e-4, rtol=1e-3)


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(ALL_PROGRAMS))
def test_cuda_bf16_kernel_gates_on_card(name):
    """The bf16 twin of ``test_torch_emit.py``'s on-card test: K1 in bf16
    (``backend="cuda"`` and ``"auto"``) against ``interp_torch`` in bf16
    and float64 on the card, Gates E and R as on the CPU: call by call,
    program by program without an accumulator, and an accumulating
    program's outputs over long sums."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (run on the GPU)")
    kplan = _plan(name)

    def run(backend, dims, **opts):
        arrs = bf16_inputs(name, kplan, np.random.default_rng(5), dims)
        exact, plain = (_numpy(compile_program(
            ALL_PROGRAMS[name](), backend="interp_torch", dtype=dt,
            device="cuda").fn(**arrs)) for dt in (torch.float64,
                                                  torch.bfloat16))
        gen = compile_program(ALL_PROGRAMS[name](), backend=backend,
                              dtype=torch.bfloat16, device="cuda", **opts)
        assert gen.interpreter == "cuda"
        with recorded_calls() as calls:
            got = gen.fn(**arrs)
        for k, v in got.items():
            assert v.dtype == torch.bfloat16 and v.is_cuda, k
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
