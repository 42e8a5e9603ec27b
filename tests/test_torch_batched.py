"""``compile_batched`` and PlanServe on the CUDA stencil kernel (K1): a
batch of examples is one launch of K1's batched kernel per grid
``CallPlan``, the counterpart of the reference's ``vmap`` over
``pallas_call`` (whose batching rule gives the Pallas grid a leading
batch axis), and each example's bits are its single call's.

Legs:

* the sources: the unbatched K1 sources are unchanged in all three
  dtypes (hashes pinned as the emitter wrote them before it learned
  batches), and a batched source differs from its single one only where
  it finds its example;
* the batched kernels compiled as host C++ (``-DHFAV_EMULATE``, outputs
  and scratch starting as NaN, the batched launch's blocks run in an
  order that interleaves the examples, so an example whose fold does not
  wait for all of its own blocks shows) and held bit for bit against
  per-example emulated single calls: every program, B = 1 and 3, row
  chunks of 1, 2 and the default, in float32, bf16 and float16; plane
  chunks and row tiles; windows in global scratch; one launch per grid
  ``CallPlan`` for a whole batch (PlanServe's micro-batches are held so in
  ``tests/test_torch_serve_plans.py``);
* the batched result against the reference's ``compile_batched`` on
  ``"interp_jax"`` and ``"jax"`` (JAX imported inside those tests);

plus the on-card case, which needs a CUDA device and ``nvcc`` and skips
without one.
"""
import concurrent.futures
import contextlib
import ctypes
import hashlib
import json
import math
import pathlib
import shutil
import subprocess

import numpy as np
import pytest
import torch

from _goldens import golden_path
from _inputs import hydro2d_state
from repro_torch.core import (ALL_PROGRAMS, PORT_ONLY, clear_compile_cache,
                              compile_batched, compile_program,
                              from_reference_dict)
from repro_torch.core.interpreters import (STENCIL_CAPABILITIES,
                                           InterpreterSpec, execute_plan,
                                           register_interpreter,
                                           unregister_interpreter)
from repro_torch.kernels.stencil2d import kernel as k1
from repro_torch.kernels.stencil2d.emit import CallLayout, emit_source

EMULATE_H = k1.CSRC / "emulate.h"
#: Odd Ni, as in the bf16 tests: 2-byte rows start in turn on and
#: between 4-byte words.
DIM = {"i": 37, "j": 9, "k": 4, "l": 3}
DTYPES = (torch.float32, torch.bfloat16, torch.float16)
#: The reference's programs (its ``compile_batched`` lacks the port's own).
REF_NAMES = sorted(set(ALL_PROGRAMS) - set(PORT_ONLY))
PLANE_WINDOW_PROGRAMS = ("heat3d", "heat3d_stage", "heat3d_residual_norm",
                         "advect4d_halo")
#: The stride of the emulated batched launch's block order: block b of n
#: runs (b * stride mod n)-th, which interleaves the examples.
BLOCK_STRIDE = 7

#: sha256 (first 16 hex digits) of each golden plan's grid-call sources
#: in each dtype, concatenated in call order, as the emitter wrote them
#: before it learned batches (but for the row prime each writes into
#: ``chunk_of``, derived from the plan's reads): the single-call kernels
#: are unchanged.
SINGLE_SOURCES = {
    "float32": {
        "advect4d_halo": "7ce7c25898bc3fae", "cosmo": "6b8c3919fc989f90",
        "energy3d": "4fe5d08bbb96864c", "heat3d": "3e8e29523f5090df",
        "heat3d_residual_norm": "568941a62af936da",
        "heat3d_stage": "157414aaf88c1788", "hydro1d": "cbde5fd94ab9081d",
        "laplace5": "aba0b8d72a16887f", "laplace_pair": "00ee6bc5ac04ec2a",
        "normalization": "cb683d8058d17edc",
        "plane_sum": "4bb673ed3b9a17d0", "pyramid4d": "cc3c970de9888473",
        "row_sum": "f15f127c6de0e72a", "smooth_norm": "09ebe4017c8136af",
        "subset_sum": "64aa52bd10b98786"},
    "bfloat16": {
        "advect4d_halo": "f5a24bd69129e665", "cosmo": "c5bfe858a28ebf1f",
        "energy3d": "4ca7d2b85d41aa5d", "heat3d": "c328b211a5d0e059",
        "heat3d_residual_norm": "cd5ee90b0f95507a",
        "heat3d_stage": "5820e93d5ad0dac2", "hydro1d": "62f7765e1fc99336",
        "laplace5": "0575ca5f04a61e10", "laplace_pair": "3db66cdc01f6d0c6",
        "normalization": "44f1c13ca358d3e3",
        "plane_sum": "df66c2695b543c98", "pyramid4d": "760327eb3d16a679",
        "row_sum": "32da988ec0e7c18f", "smooth_norm": "6d13f409b45efb93",
        "subset_sum": "903058bcf19449ec"},
    "float16": {
        "advect4d_halo": "7288bb43c9c8ef1a", "cosmo": "94a1d6addc51c16f",
        "energy3d": "29fe4d2770460222", "heat3d": "fe0abc3ed9a1b60e",
        "heat3d_residual_norm": "029ac0480abaa086",
        "heat3d_stage": "34f8323e3e671c27", "hydro1d": "b5609f92e064482c",
        "laplace5": "6bb546b24a20e980", "laplace_pair": "11556491bef9908a",
        "normalization": "ebdf5e1820d7935d",
        "plane_sum": "e1df323b450ee052", "pyramid4d": "221fa92b14fe9cee",
        "row_sum": "cc09a04a94540771", "smooth_norm": "93ae2b074ce9bb07",
        "subset_sum": "a82a5b1187f7cddf"},
}


def _golden(name):
    return from_reference_dict(
        json.loads(golden_path(name).read_text()))


def _plan(name):
    return compile_program(ALL_PROGRAMS[name](), backend="interp_torch",
                           device="cpu").kernel_plan


def _dname(dtype) -> str:
    return str(dtype).removeprefix("torch.")


def inputs(name, kplan, rng, dtype=torch.float32, dims=DIM):
    """One seeded array per axiom of ``kplan`` at ``dims`` (hydro1d's
    density positive, as in the repository's hydro benchmark), rounded
    to ``dtype`` and held as float32 (each value exact in both)."""
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


def batch_of(examples: list) -> dict:
    return {k: torch.stack([e[k] for e in examples]) for k in examples[0]}


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal dtype, shape and bits (a NaN equal to the same NaN)."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    view = {4: torch.int32, 2: torch.int16}[a.element_size()]
    return torch.equal(a.contiguous().view(view), b.contiguous().view(view))


# ---------------------------------------------------------------------------
# The sources
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES, ids=_dname)
@pytest.mark.parametrize("name", sorted(SINGLE_SOURCES["float32"]))
def test_single_sources_are_unchanged(name, dtype):
    h = hashlib.sha256()
    for call in _golden(name).calls:
        if call.has_grid:
            src = emit_source(call, dtype)
            assert src == emit_source(call, dtype, batched=False)
            h.update(src.encode())
    assert h.hexdigest()[:16] == SINGLE_SOURCES[_dname(dtype)][name]


@pytest.mark.parametrize("name", sorted(ALL_PROGRAMS))
def test_batched_source_differs_only_where_it_finds_its_example(name):
    """The batched kernel is the single call's with the example decoded
    from the grid's outermost factor: its operands moved by
    ``hfav::example``, the block within its example in the scratch's and
    the fold's place of ``blockIdx.x``."""
    for call in _golden(name).calls:
        if not call.has_grid:
            continue
        single = emit_source(call).splitlines()
        batched = emit_source(call, batched=True).splitlines()
        assert emit_source(call, batched=True) == emit_source(call,
                                                              batched=True)
        added = [ln for ln in batched if ln not in single]
        removed = [ln for ln in single if ln not in batched]
        # each changed line, and four new ones: the batched parameters'
        # count, the example, its operands, the block within it
        assert len(removed) <= 6, removed
        assert len(added) == len(removed) + 4, (added, removed)
        assert any("hfav::example<HFAV_ND>(PB, ex)" in ln for ln in added)
        assert "blockIdx.x % nblocks" in "\n".join(added)
        body = "\n".join(batched)
        assert body.count("blockIdx.x") == 2  # the example and the block
        assert body.rstrip().endswith(
            "HFAV_ENTRY_POINTS(hfav_kernel, HFAV_NP, HFAV_NB)")


# ---------------------------------------------------------------------------
# The emulated kernels
# ---------------------------------------------------------------------------

_EMU_LIBS: dict = {}


def _digest(src: str) -> str:
    return hashlib.sha256(src.encode() + k1.HEADER.read_bytes()
                          + EMULATE_H.read_bytes()).hexdigest()[:24]


def _compile(src: str, build_dir: pathlib.Path) -> pathlib.Path:
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


def _emulated(call, dtype, batched, build_dir):
    src = emit_source(call, dtype, batched)
    digest = _digest(src)
    if digest not in _EMU_LIBS:
        lib = ctypes.CDLL(str(_compile(src, build_dir)))
        k1._bind(lib)
        lib.hfav_emulate_block_stride.argtypes = [ctypes.c_longlong]
        lib.hfav_emulate_block_stride(BLOCK_STRIDE if batched else 1)
        _EMU_LIBS[digest] = lib
    return _EMU_LIBS[digest]


def _prebuild(build_dir):
    """Compile every program's single and batched sources in the three
    dtypes, several compilers at a time."""
    srcs = {}
    for name in ALL_PROGRAMS:
        for call in _plan(name).calls:
            if call.has_grid:
                for dtype in DTYPES:
                    for batched in (False, True):
                        src = emit_source(call, dtype, batched)
                        srcs[_digest(src)] = src
    with concurrent.futures.ThreadPoolExecutor(4) as pool:
        list(pool.map(lambda s: _compile(s, build_dir), srcs.values()))


@contextlib.contextmanager
def emulated_interpreter(build_dir, name="_emulated_cuda_batched"):
    """The emulated K1 registered as interpreter ``name`` of float32,
    bf16 and float16 with a batched ``build_call``, its outputs and
    scratch starting as NaN (a step no block writes shows), while the
    context lasts."""

    def build_call(call, sizes, dtype, *, device=None, chunk=None,
                   plane_chunk=None):
        lay = CallLayout(call, dtype)
        lib = _emulated(call, dtype, False, build_dir)
        run = lay.concretize(tuple(sizes), k1.occupancy(lib), chunk,
                             plane_chunk=plane_chunk)

        def fn(*args):
            return k1.run_kernel(lib, lay, run, args, threads=3,
                                 stream=None)
        return fn, run.steps_j

    def build_batched(call, sizes, dtype, *, device=None, chunk=None,
                      plane_chunk=None):
        # as kernel.build_batched: the single call's launch, from the
        # single kernel's residency, once for each example
        lay = CallLayout(call, dtype)
        single = _emulated(call, dtype, False, build_dir)
        lib = _emulated(call, dtype, True, build_dir)
        run = lay.concretize(tuple(sizes), k1.occupancy(single), chunk,
                             plane_chunk=plane_chunk)
        shapes = k1.input_shapes(call, sizes)

        def fn(*args):
            batch = args[0].shape[0]
            for t, shape in zip(args, shapes):
                assert tuple(t.shape) == (batch, *shape), t.shape
                assert t.dtype == dtype
            brun = k1.batch_launch(lay, run, shapes, batch)
            return k1.run_kernel(lib, lay, brun, args, threads=3,
                                 stream=None)
        return fn, run.steps_j

    def poisoned(lay, run, device):  # a step no block writes stays NaN
        outs, scratch = alloc_outputs(lay, run, device)
        for t in outs + [scratch]:
            t.fill_(float("nan"))
        return outs, scratch

    alloc_outputs = k1.alloc_outputs
    k1.alloc_outputs = poisoned
    register_interpreter(InterpreterSpec(
        name, build_call, STENCIL_CAPABILITIES, dtypes=frozenset(DTYPES),
        flags=frozenset({"chunk", "plane_chunk"}),
        build_batched=build_batched))
    clear_compile_cache()
    try:
        yield name
    finally:
        clear_compile_cache()
        unregister_interpreter(name)
        k1.alloc_outputs = alloc_outputs


@pytest.fixture(scope="module")
def emulator(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("no host C++ compiler (g++) to emulate the kernels")
    build_dir = tmp_path_factory.mktemp("emulated_batched_kernels")
    _prebuild(build_dir)
    with emulated_interpreter(build_dir) as name:
        yield name


_SINGLES: dict = {}


def single_outputs(name, dtype, emulator, b: int, **opts):
    """Example ``b``'s inputs of program ``name`` (seed 100 + b) and its
    outputs from one emulated single call (memoized)."""
    dims = opts.pop("dims", DIM)
    key = (name, dtype, b, tuple(sorted(dims.items())),
           tuple(sorted(opts.items())))
    if key not in _SINGLES:
        arrs = inputs(name, _plan(name), np.random.default_rng(100 + b),
                      dtype, dims)
        gen = compile_program(ALL_PROGRAMS[name](), backend=emulator,
                              device="cpu", dtype=dtype, **opts)
        _SINGLES[key] = (arrs, gen.fn(**arrs))
    return _SINGLES[key]


def grid_calls(name) -> int:
    return sum(c.has_grid for c in _plan(name).calls)


def check_batched(name, dtype, emulator, batch, **opts):
    """The emulated batched call of ``batch`` examples against each
    example's emulated single call, bit for bit, in one launch per grid
    ``CallPlan``; returns the batched outputs."""
    singles = [single_outputs(name, dtype, emulator, b, **opts)
               for b in range(batch)]
    bgen = compile_batched(ALL_PROGRAMS[name](), emulator, device="cpu",
                           dtype=dtype,
                           **{k: v for k, v in opts.items() if k != "dims"})
    assert bgen.gen.batch_fn is not None
    before = k1.launches
    out = bgen.fn(batch_of([arrs for arrs, _ in singles]))
    assert k1.launches - before == grid_calls(name)
    for b, (_, want) in enumerate(singles):
        assert set(out) == set(want)
        for k in want:
            assert out[k].shape[0] == batch
            assert same_bits(out[k][b], want[k]), (name, k, b)
    return out


@pytest.mark.parametrize("chunk", [1, 2, None])
@pytest.mark.parametrize("batch", [1, 3])
@pytest.mark.parametrize("dtype", DTYPES, ids=_dname)
@pytest.mark.parametrize("name", sorted(ALL_PROGRAMS))
def test_emulated_batch_is_per_example_bit_for_bit(name, dtype, batch, chunk,
                                                   emulator):
    out = check_batched(name, dtype, emulator, batch, chunk=chunk)
    # every step the program owns was written: no NaN of the poisoned
    # outputs and scratch reached a result the plain version has finite
    plain = compile_program(ALL_PROGRAMS[name](), backend="interp_torch",
                            device="cpu", dtype=dtype)
    for b in range(batch):
        arrs, _ = single_outputs(name, dtype, emulator, b, chunk=chunk)
        want = plain.fn(**arrs)
        for k in want:
            nan = torch.isnan(out[k][b].float())
            assert not (nan & ~torch.isnan(want[k].float())).any(), (k, b)


@pytest.mark.parametrize("plane_chunk", [1, 2, 3])
@pytest.mark.parametrize("chunk", [1, 3, None])
@pytest.mark.parametrize("name", PLANE_WINDOW_PROGRAMS)
def test_emulated_batch_in_plane_chunks_and_row_tiles(name, chunk,
                                                      plane_chunk, emulator):
    """Forced plane chunks (3 does not divide Nk = 4) and row tiles: a
    batch of 3 in one launch, each example its single call's bits."""
    check_batched(name, torch.float32, emulator, 3, chunk=chunk,
                  plane_chunk=plane_chunk)


@pytest.mark.parametrize("name", sorted(ALL_PROGRAMS))
def test_emulated_batch_from_global_scratch(name, emulator, monkeypatch):
    """With a shared-memory limit no region fits, every block of every
    example keeps its windows in its example's global scratch."""
    from repro_torch.kernels.stencil2d import emit
    monkeypatch.setattr(emit, "SMEM_LIMIT", 4)
    runs = []
    real = k1.batch_launch

    def recorded(*a, **k):
        runs.append(real(*a, **k))
        return runs[-1]

    monkeypatch.setattr(k1, "batch_launch", recorded)
    clear_compile_cache()
    _SINGLES.clear()
    try:
        check_batched(name, torch.float32, emulator, 3, chunk=2)
    finally:
        _SINGLES.clear()
        clear_compile_cache()
    assert runs and all(r.smem_bytes == 0 and r.batch == 3 for r in runs)


@pytest.mark.parametrize("name,dims,opts", [
    ("normalization", dict(DIM, j=64), {"chunk": 1}),
    ("heat3d_residual_norm", dict(DIM, k=5, j=9), {"chunk": 1,
                                                   "plane_chunk": 1}),
    ("plane_sum", dict(DIM, j=11), {"chunk": 1})])
def test_emulated_batch_folds_each_example(name, dims, opts, emulator):
    """The device fold in groups of 16 (64 partial rows), in one block
    (45) and per kept tile, once for each example on its own tickets, in
    a launch whose blocks interleave the examples; the tickets are left
    at zero for the next launch."""
    out = check_batched(name, torch.float32, emulator, 3, dims=dims, **opts)
    again = check_batched(name, torch.float32, emulator, 3, dims=dims,
                          **opts)
    for k in out:
        assert same_bits(out[k], again[k]), k
    for key, t in k1._TICKETS.items():
        assert not t.any(), key


def test_batch_launch_parameters():
    """The batched launch is the single call's grid once for each
    example, with each pointer's per-example bytes after the single
    call's size parameters, a scratch and tickets per example, and
    refuses a grid past 2**31 - 1 blocks."""
    call = _plan("normalization").calls[0]
    lay = CallLayout(call, torch.bfloat16)
    sizes = (9, 37)
    run = lay.concretize(sizes, 4, 2)
    shapes = k1.input_shapes(call, sizes)
    brun = k1.batch_launch(lay, run, shapes, 5)
    assert brun.nblocks == 5 * run.nblocks and brun.batch == 5
    assert brun.ints[:len(run.ints)] == run.ints
    strides = brun.ints[len(run.ints):]
    assert len(strides) == lay.n_ptrs
    outs = k1.output_shapes(lay, run)
    assert list(strides[:len(shapes) + len(outs)]) == [
        2 * math.prod(s) for s in shapes + outs]
    slab = strides[-2] // 4
    assert slab % 4 == 0 and slab >= run.scratch_floats
    assert brun.scratch_floats == 5 * slab
    assert strides[-1] == 4 * run.tickets and brun.tickets == 5 * run.tickets
    with pytest.raises(ValueError, match="past the grid"):
        k1.batch_launch(lay, run, shapes, k1.MAX_GRID // run.nblocks + 1)
    # the bytes the batch must move: five times a single call's
    from repro_torch.kernels.stencil2d import bench
    args = [torch.empty(s, dtype=torch.bfloat16) for s in shapes]
    bargs = [torch.empty((5, *s), dtype=torch.bfloat16) for s in shapes]
    assert bench.call_bytes(lay, brun, bargs) \
        == 5 * bench.call_bytes(lay, run, args)


def test_plain_versions_keep_the_per_example_loop():
    """``interp_torch`` and the ``"torch"`` emitter declare no batched
    ``build_call``: their batches run example by example; the CUDA
    kernel declares one, and a batched host half on an interpreter
    without one raises."""
    from repro_torch.core import get_interpreter
    assert get_interpreter("cuda").build_batched is k1.build_batched
    assert get_interpreter("interp_torch").build_batched is None
    for backend in ("interp_torch", "torch"):
        bgen = compile_batched(ALL_PROGRAMS["laplace5"](), backend,
                               device="cpu")
        assert getattr(bgen.gen, "batch_fn", None) is None
    with pytest.raises(ValueError, match="declares no batched"):
        execute_plan(_plan("laplace5"), interpreter="interp_torch",
                     device="cpu", batched=True)


def test_batched_cuda_refuses_cpu_tensors_and_never_loops():
    """On CPU tensors the batched kernel raises: ``compile_batched`` on
    ``"cuda"`` never falls back to a per-example loop, and launches
    nothing."""
    bgen = compile_batched(ALL_PROGRAMS["laplace5"](), "cuda", device="cpu")
    assert bgen.gen.batch_fn is not None
    before = k1.launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        bgen.fn({"cell": np.zeros((2, 7, 20), np.float32)})
    fn, _ = k1.build_batched(_plan("laplace5").calls[0], (7, 20),
                             torch.float32)
    with pytest.raises(ValueError, match="CUDA tensors"):
        fn(torch.zeros((2, 7, 20)))
    assert k1.launches == before


# ---------------------------------------------------------------------------
# Against the reference's compile_batched
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["interp_jax", "jax"])
@pytest.mark.parametrize("name", REF_NAMES)
def test_emulated_batch_matches_reference_compile_batched(name, backend,
                                                          emulator):
    """The batched K1 against the reference's ``vmap``-ed, jitted
    ``compile_batched`` (its plain interpreter and its fused-source
    emitter; the reference's Pallas interpreter does not run on this
    jax) on the same batch of 3."""
    from repro.core.engine import compile_batched as ref_batched
    from repro.core.programs import ALL_PROGRAMS as REF_PROGRAMS

    got = check_batched(name, torch.float32, emulator, 3, chunk=2)
    batch = batch_of([single_outputs(name, torch.float32, emulator, b,
                                     chunk=2)[0] for b in range(3)])
    want = ref_batched(REF_PROGRAMS[name](), backend).fn(
        {k: v.numpy() for k, v in batch.items()})
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=2e-4, rtol=1e-3,
                                   err_msg=f"{name}/{backend}:{k}")


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=_dname)
@pytest.mark.parametrize("name", sorted(ALL_PROGRAMS))
def test_cuda_batch_is_one_launch_per_call_and_per_example_bits(name, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (run on the GPU)")
    kplan = _plan(name)
    examples = [{k: v.cuda() for k, v in
                 inputs(name, kplan, np.random.default_rng(100 + b),
                        dtype).items()} for b in range(3)]
    for backend in ("cuda", "auto"):
        bgen = compile_batched(ALL_PROGRAMS[name](), backend, dtype=dtype)
        single = compile_program(ALL_PROGRAMS[name](), backend, dtype=dtype)
        before = k1.launches
        out = bgen.fn(batch_of(examples))
        torch.cuda.synchronize()
        assert k1.launches - before == grid_calls(name)
        for b, ex in enumerate(examples):
            want = single.fn(**ex)
            for k in want:
                assert same_bits(out[k][b], want[k]), (backend, k, b)
