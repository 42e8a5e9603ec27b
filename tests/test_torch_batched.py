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
* the batched kernels compiled as host C++ (``-DHFAV_EMULATE``, the
  emulated ``"cuda"`` interpreter of ``tests/_emulate.py``: outputs
  seated as on the card, outputs and scratch starting as NaN, the batched
  launch's blocks run in an order that interleaves the examples, so an
  example whose fold does not wait for all of its own blocks shows) and held bit for bit against
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
import hashlib
import math

import numpy as np
import pytest
import torch

from _emulate import ODD_DIM as DIM
from _emulate import (SOURCES, _dname, _golden, _plan, emulated, grid_calls,
                      inputs, prebuild, same_bits)
from repro_torch.core import (ALL_PROGRAMS, PORT_ONLY, clear_compile_cache,
                              compile_batched, compile_program)
from repro_torch.core.interpreters import execute_plan
from repro_torch.kernels.stencil2d import kernel as k1
from repro_torch.kernels.stencil2d.emit import CallLayout, emit_source

DTYPES = (torch.float32, torch.bfloat16, torch.float16)
#: The reference's programs (its ``compile_batched`` lacks the port's own).
REF_NAMES = sorted(set(ALL_PROGRAMS) - set(PORT_ONLY))
PLANE_WINDOW_PROGRAMS = ("heat3d", "heat3d_stage", "heat3d_residual_norm",
                         "advect4d_halo")


def batch_of(examples: list) -> dict:
    return {k: torch.stack([e[k] for e in examples]) for k in examples[0]}


# ---------------------------------------------------------------------------
# The sources
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES, ids=_dname)
@pytest.mark.parametrize("name", sorted(SOURCES["float32"]))
def test_single_sources_are_unchanged(name, dtype):
    h = hashlib.sha256()
    for call in _golden(name).calls:
        if call.has_grid:
            src = emit_source(call, dtype)
            assert src == emit_source(call, dtype, batched=False)
            h.update(src.encode())
    assert h.hexdigest()[:16] == SOURCES[_dname(dtype)][name]


@pytest.mark.parametrize("name", sorted(ALL_PROGRAMS))
def test_batched_source_differs_only_where_it_finds_its_example(name):
    """The batched kernel is the single call's with the example decoded
    from the grid's outermost factor: its operands found by
    ``hfav::example`` (its inputs through the table of addresses), the
    block within its example in the scratch's and the fold's place of
    ``blockIdx.x``."""
    for call in _golden(name).calls:
        if not call.has_grid:
            continue
        single = emit_source(call).splitlines()
        batched = emit_source(call, batched=True).splitlines()
        assert emit_source(call, batched=True) == emit_source(call,
                                                              batched=True)
        added = [ln for ln in batched if ln not in single]
        removed = [ln for ln in single if ln not in batched]
        # each changed line, and five new ones: the count of inputs read
        # through the table, the batched parameters' count, the example,
        # its operands, the block within it
        assert len(removed) <= 6, removed
        assert len(added) == len(removed) + 5, (added, removed)
        assert f"#define HFAV_NI {len(call.inputs)}" in added
        assert any("hfav::example<HFAV_ND, HFAV_NI>(PB, ex)" in ln
                   for ln in added)
        assert "blockIdx.x % nblocks" in "\n".join(added)
        body = "\n".join(batched)
        assert body.count("blockIdx.x") == 2  # the example and the block
        assert body.rstrip().endswith(
            "HFAV_ENTRY_POINTS(hfav_kernel, HFAV_NP, HFAV_NB)")


# ---------------------------------------------------------------------------
# The emulated kernels
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def emulator():
    """The emulated K1, every program's single and batched seated sources
    in the three dtypes compiled first, several compilers at a time."""
    prebuild([(call, dtype, True) for name in ALL_PROGRAMS
              for call in _plan(name).calls if call.has_grid
              for dtype in DTYPES])
    with emulated() as name:
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


@pytest.mark.parametrize("name", sorted(ALL_PROGRAMS))
def test_emulated_batch_of_member_tensors_is_the_stacked_batch(
        name, emulator, monkeypatch):
    """``compile_batched`` over each input given as the list of the
    examples' own tensors: the stacked batch's bits, in one launch per
    grid ``CallPlan``, and nothing stacked but a scalar input (hydroc's
    ``dtdx``), the one kind of input a program's plan reads on the host
    (each call's table holds the members' addresses; normalization's and
    smooth_norm's second call's, the slices of the first call's stacked
    output)."""
    stacked = check_batched(name, torch.float32, emulator, 3, chunk=None)
    members = [single_outputs(name, torch.float32, emulator, b,
                              chunk=None)[0] for b in range(3)]
    bgen = compile_batched(ALL_PROGRAMS[name](), emulator, device="cpu",
                           chunk=None)
    stacks = []
    real = torch.stack
    monkeypatch.setattr(torch, "stack",
                        lambda *a, **k: stacks.append(1) or real(*a, **k))
    before = k1.launches
    out = bgen.fn({k: [m[k] for m in members] for k in members[0]})
    assert k1.launches - before == grid_calls(name)
    scalars = {i.name for call in _plan(name).calls for i in call.inputs
               if i.scalar and i.name in members[0]}
    assert len(stacks) == len(scalars)
    assert set(out) == set(stacked)
    for k in out:
        assert same_bits(out[k], stacked[k]), k


def test_emulated_batch_stacks_members_the_host_half_reads(emulator,
                                                           monkeypatch):
    """Where the host half reads an input itself (a lane pass here, which
    this test adds to laplace5's plan: no plan K1 runs has one, since K1
    refuses LayoutApply's constructs), a batch given as its examples'
    tensors is stacked there, once, and gives the stacked batch's bits;
    examples of unequal shapes raise ``ValueError``."""
    import dataclasses

    from repro_torch.core.plan import LanePass
    kplan = _plan("laplace5")
    rng = np.random.default_rng(5)
    members = [inputs("laplace5", kplan, rng, dims=dict(DIM, i=20))["cell"]
               for _ in range(3)]
    width = members[0].shape[-1]
    assert width % 2 == 0
    plan = dataclasses.replace(kplan,
                               pre_passes=(LanePass("cell", 2, width),))
    fn = execute_plan(plan, interpreter=emulator, device="cpu",
                      batched=True)
    want = fn(cell=torch.stack(members))
    stacks = []
    real = torch.stack
    monkeypatch.setattr(torch, "stack",
                        lambda *a, **k: stacks.append(1) or real(*a, **k))
    got = fn(cell=members)
    assert len(stacks) == 1
    for k in want:
        assert same_bits(got[k], want[k]), k
    bgen = compile_batched(ALL_PROGRAMS["laplace5"](), emulator,
                           device="cpu")
    with pytest.raises(ValueError, match="first example's shape"):
        bgen.fn({"cell": [members[0], members[1][:, 1:].contiguous()]})


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
    example, with the per-example bytes of each pointer of the launch's
    own (outputs, scratch, tickets) after the single call's size
    parameters, a scratch and tickets per example, its inputs read
    through a table of addresses (one row an input, one column an
    example), and refuses a grid past 2**31 - 1 blocks."""
    call = _plan("normalization").calls[0]
    lay = CallLayout(call, torch.bfloat16)
    sizes = (9, 37)
    run = lay.concretize(sizes, 4, 2)
    shapes = k1.input_shapes(call, sizes)
    brun = k1.batch_launch(lay, run, 5)
    assert brun.nblocks == 5 * run.nblocks and brun.batch == 5
    assert brun.ints[:len(run.ints)] == run.ints
    strides = brun.ints[len(run.ints):]
    outs = k1.output_shapes(lay, run)
    assert len(strides) == lay.n_ptrs - len(shapes) == len(outs) + 2
    assert list(strides[:len(outs)]) == [2 * math.prod(s) for s in outs]
    slab = strides[-2] // 4
    assert slab % 4 == 0 and slab >= run.scratch_floats
    assert brun.scratch_floats == 5 * slab
    assert strides[-1] == 4 * run.tickets and brun.tickets == 5 * run.tickets
    with pytest.raises(ValueError, match="past the grid"):
        k1.batch_launch(lay, run, k1.MAX_GRID // run.nblocks + 1)
    # the table: each example's address of each input, where it lies
    members = [[torch.empty(s, dtype=torch.bfloat16) for _ in range(5)]
               for s in shapes]
    _, tensors = k1.launch_tensors(lay, brun, members)
    for row, ins in zip(tensors, members):
        assert row.dtype == torch.int64
        assert row.tolist() == [t.data_ptr() for t in ins]
    # the bytes the batch must move: five times a single call's
    from repro_torch.kernels.stencil2d import bench
    args = [torch.empty(s, dtype=torch.bfloat16) for s in shapes]
    assert bench.call_bytes(lay, brun, members) \
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
        # the examples' own tensors, read through the table where they lie
        before = k1.launches
        seq = bgen.fn({k: [ex[k].to(dtype) for ex in examples]
                       for k in examples[0]})
        torch.cuda.synchronize()
        assert k1.launches - before == grid_calls(name)
        for k in out:
            assert same_bits(seq[k], out[k]), (backend, k)
