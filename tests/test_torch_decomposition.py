"""K1's row decomposition: the row prime a block walks before its first
owned row is read from the plan (the longest chain of reads back through
the rolling windows), and the chooser takes any count of chunks.

* The emulated kernel (``-DHFAV_EMULATE``, ``tests/_emulate.py``: outputs
  seated as on the card, outputs and global scratch poisoned with NaN) at forced row chunks of 1, 2, 3 and 5 and at the
  chooser's own gives the single-chunk launch's bits on every program
  without accumulators; one row fewer of prime breaks an owned row of
  cosmo and hydro2d, so the derived prime is the least that is right.
* The chooser fills the card's SMs at hydro2d's operational size.
* Each launch counts the row steps its blocks walk and own, its blocks
  and the blocks its waves hold.
"""
import numpy as np
import pytest
import torch

from _emulate import DIM, _arrays, _plan
from _emulate import emulator  # noqa: F401 (the emulated K1)
from repro_torch import obs
from repro_torch.core import ALL_PROGRAMS, compile_program
from repro_torch.kernels.stencil2d import kernel as k1
from repro_torch.kernels.stencil2d.emit import CallLayout

#: Rows enough for chunks of 5 to start past every program's prime.
DIMS = dict(DIM, j=17)
#: The programs whose calls keep no accumulator: each owned row is
#: computed by the same arithmetic from the same rows in any chunking.
NO_ACC = sorted(n for n in ALL_PROGRAMS
                if not any(c.accs for c in _plan(n).calls))


def _steps_j(kplan, dims) -> int:
    """The most row steps of any of ``kplan``'s grid calls at ``dims``."""
    return max(dims[c.row_dim] + c.x_hi_off - c.x_lo
               for c in kplan.calls if c.has_grid)


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view(torch.int32)


def _run(name, backend, arrs, **opts):
    return compile_program(ALL_PROGRAMS[name](), backend=backend,
                           device="cpu", use_cache=False, **opts).fn(**arrs)


@pytest.mark.parametrize("name,prime", [
    ("hydro2d", 4), ("cosmo", 4), ("pyramid4d", 4), ("laplace5", 2),
    ("laplace_pair", 2), ("hydro1d", 0), ("row_sum", 0),
    ("heat3d", 2), ("heat3d_stage", 2), ("advect4d_halo", 0)])
def test_row_prime_follows_the_reads(name, prime):
    """hydro2d: ``y_update`` reads the y fluxes a row back (1), written
    beside ``y_riemann``, which reads the traced states a row back (1),
    which read the primitives two rows back (2): 4 rows, where the sum of
    its 25 windows' stages was 50.  cosmo: the y flux a row back (1), the
    Laplacian a row back (1), the input two rows back (2)."""
    assert [CallLayout(c).prime for c in _plan(name).calls
            if c.has_grid] == [prime]


@pytest.mark.parametrize("name", NO_ACC)
def test_emulated_chunks_match_one_chunk_bit_for_bit(name, emulator):
    kplan = _plan(name)
    arrs = _arrays(kplan, np.random.default_rng(7), DIMS)
    one = _run(name, emulator, arrs, chunk=_steps_j(kplan, DIMS))
    for k in one:
        assert torch.isfinite(one[k]).any(), k
    for chunk in (1, 2, 3, 5, None):
        got = _run(name, emulator, arrs, chunk=chunk)
        for k in one:
            assert torch.equal(_bits(got[k]), _bits(one[k])), \
                f"{name}/chunk={chunk}:{k}"


@pytest.mark.parametrize("name", ["cosmo", "hydro2d"])
def test_one_row_less_of_prime_breaks_an_owned_row(name, emulator,
                                                   monkeypatch):
    kplan = _plan(name)
    arrs = _arrays(kplan, np.random.default_rng(8), DIMS)
    one = _run(name, emulator, arrs, chunk=_steps_j(kplan, DIMS))
    reach = CallLayout._row_reach
    monkeypatch.setattr(CallLayout, "_row_reach",
                        lambda self: reach(self) - 1)
    monkeypatch.setattr(k1, "_CALLS", {})  # layouts with the shorter prime
    assert CallLayout(kplan.calls[0]).prime == 3
    got = _run(name, emulator, arrs, chunk=5)
    assert any(not torch.equal(_bits(got[k]), _bits(one[k]))
               or not torch.isfinite(got[k]).all() for k in one)


def test_chooser_fills_every_sm_on_hydro2d():
    """At 10000 x 10000 and one block an SM, hydro2d takes one wave of at
    least 132 blocks, each walking at most 80 row steps (it took 79
    blocks of 128 rows and 50 priming rows while chunk lengths were powers
    of two and the prime summed every window's stages)."""
    lay = CallLayout(_plan("hydro2d").calls[0])
    run = lay.concretize((10000, 10000), 1)
    assert run.nblocks >= 132 and run.waves == 1
    assert min(run.chunk_len + lay.prime, run.steps_j) <= 80
    assert run.rows_owned == run.steps_j
    assert run.rows_walked <= run.rows_owned * 1.06


@pytest.mark.parametrize("sizes,resident", [
    ((10000, 10000), 1), ((37, 200), 4)])
def test_launch_row_steps_follow_chunk_of(sizes, resident):
    """``Launch.rows_walked`` is the sum of each block's walk by
    ``hfav::chunk_of``'s formula, ``rows_owned`` the range's row steps."""
    lay = CallLayout(_plan("hydro2d").calls[0])
    for chunk in (None, 1, 3, 7):
        run = lay.concretize(sizes, resident, chunk)
        walks = [min(own + run.chunk_len, run.steps_j)
                 - max(own - lay.prime, 0)
                 for own in range(0, run.steps_j, run.chunk_len)]
        assert len(walks) == run.nblocks
        assert run.rows_walked == sum(walks)
        assert run.rows_owned == run.steps_j


def test_each_launch_counts_its_decomposition(emulator, monkeypatch):
    arrs = _arrays(_plan("cosmo"), np.random.default_rng(9), DIMS)
    names = ("k1.rows_walked", "k1.rows_owned", "k1.blocks",
             "k1.block_slots")
    before = {n: obs.counter(n) for n in names}
    runs = []
    real = k1.run_kernel

    def recording(lib, lay, run, args, **kw):
        runs.append(run)
        return real(lib, lay, run, args, **kw)

    monkeypatch.setattr(k1, "run_kernel", recording)
    _run("cosmo", emulator, arrs, chunk=3)
    (run,) = runs
    assert run.rows_walked > run.rows_owned > 0
    want = (run.rows_walked, run.rows_owned, run.nblocks,
            run.waves * run.sms * run.resident)
    assert tuple(obs.counter(n) - before[n] for n in names) == want
    assert run.nblocks <= want[3]
