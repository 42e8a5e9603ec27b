"""K1's seated store: each ``external`` output the plan's rule admits
(``interpreters.seatable``) is stored by the kernel at its seat in a
goal-shaped array, borders included, so the host half neither fills nor
copies it.

Legs:

* the rule, read from the plan alone;
* the seated kernels compiled as host C++ (``-DHFAV_EMULATE``, the
  emulated ``"cuda"`` interpreter of ``tests/_emulate.py``, every output
  starting as NaN, so an element the kernel neither stores nor fills
  shows) against ``assemble`` of the outputs of its padded twin (the
  padded contract, ``seats=False``), bit
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
import dataclasses

import numpy as np
import pytest
import torch

from _emulate import ODD_DIM as DIM
from _emulate import (NAME, _dname, _plan, emulated, emulated_spec, inputs,
                      prebuild, same_bits)
from repro_torch import obs
from repro_torch.core import ALL_PROGRAMS
from repro_torch.core.interpreters import (assemble, execute_plan,
                                           get_interpreter,
                                           register_interpreter, seatable,
                                           unregister_interpreter)
from repro_torch.kernels.stencil2d.emit import CallLayout, emit_source

DTYPES = (torch.float32, torch.bfloat16, torch.float16)
#: Border rows (cosmo, j 2 -2), a whole-array seat (hydro1d, j 0 0),
#: border tiles (heat3d's plane dim, advect4d_halo's inner outer dim).
BORDERS = ("cosmo", "hydro1d", "heat3d", "advect4d_halo")
#: The padded twin of the emulated K1: the padded contract, re-seated by
#: ``assemble``.
PADDED = "_emu_padded"


# ---------------------------------------------------------------------------
# The rule
# ---------------------------------------------------------------------------

def test_seatable_reads_the_plan():
    """Every program's ``external`` outputs are seated (cosmo's j 2 -2
    at x_lo -2, hydro1d's whole array, heat3d's border planes, hydro2d's
    and hydroc's four), no
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
    assert seen == 20
    call = _plan("heat3d").calls[0]
    out = call.outputs[0]
    assert (out.outer_lo, out.outer_hi, call.outer_lo) == ((1,), (-1,), (-1,))
    assert not seatable(call, dataclasses.replace(out, outer_lead=(3,)))
    assert not seatable(call, dataclasses.replace(out, lead=3))
    assert not seatable(call, dataclasses.replace(out, kind="full"))


# ---------------------------------------------------------------------------
# The emulated kernels
# ---------------------------------------------------------------------------

def _cases():
    return [(n, torch.float32) for n in sorted(ALL_PROGRAMS)] \
        + [(n, d) for n in BORDERS for d in DTYPES[1:]]


@pytest.fixture(scope="module")
def emulators():
    """The emulated K1 (``seats``, as the card) and its padded twin
    ``_emu_padded``, every case's single and batched sources, padded and
    seated, compiled first, several compilers at a time."""
    prebuild([(call, dtype, seated) for name, dtype in _cases()
              for call in _plan(name).calls if call.has_grid
              for seated in (False, True)])
    seated = emulated_spec()
    assert seated.seats
    with emulated(seated, emulated_spec(PADDED, seats=False)):
        yield


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
    for interp in (PADDED, NAME):
        seated0, reseated0 = obs.counter("k1.seated"), \
            obs.counter("plan.reseated")
        run[interp] = execute_plan(kplan, interpreter=interp, dtype=dtype,
                                   device="cpu", batched=bool(batch),
                                   chunk=2)(**arrs)
        run[interp + ".counts"] = (obs.counter("k1.seated") - seated0,
                                   obs.counter("plan.reseated") - reseated0)
    n_ext = sum(o.kind == "external" for c in kplan.calls if c.has_grid
                for o in c.outputs)
    assert run[PADDED + ".counts"] == (0, n_ext)
    assert run[NAME + ".counts"] == (n_ext, 0)
    want, got = run[PADDED], run[NAME]
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
                 for i in (PADDED, NAME))
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
    with emulated(emulated_spec("cuda")):
        before = (obs.counter("k1.seated"), obs.counter("plan.reseated"),
                  obs.counter("k1.launch"))
        got = execute_plan(kplan, interpreter="cuda", device="cpu")(**arrs)
        after = (obs.counter("k1.seated"), obs.counter("plan.reseated"),
                 obs.counter("k1.launch"))
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
