"""The readers of K1's row decomposition, ``k1_prime_share`` and
``k1_wave_fill``: None against counters a port without them leaves
absent, and the stated shares of hand-made launches counted as K1 counts
its own."""
import pytest

from portbench import harness
from portbench.metrics import k1_prime_share, k1_wave_fill

NAMES = ("k1_prime_share", "k1_wave_fill")


def _launch(nblocks, waves, resident, walked, owned, batch=0):
    from repro_torch.kernels.stencil2d.emit import Launch
    return Launch(ints=(), nblocks=nblocks, threads=1024, smem_bytes=0,
                  scratch_floats=0, gsz=(), steps_j=owned, nchunks=nblocks,
                  ni=10000, sizes=(10000, 10000), resident=resident,
                  waves=waves, batch=batch, sms=132, rows_walked=walked,
                  rows_owned=owned)


@pytest.fixture
def counters(monkeypatch):
    from repro_torch import obs
    monkeypatch.setattr(obs, "_counts", {})
    return obs


def test_entries_name_the_cells_that_count_k1():
    bench = harness.load_benchmark()
    entries = {m["name"]: m for m in bench["per_layer"]
               if m["name"] in NAMES}
    assert set(entries) == set(NAMES)
    for m in entries.values():
        assert m["source"] == "program_counter" and m["unit"] == "%"
        assert m["layer"] == "K1 stencil kernel"
        assert m["moves"] == "points_per_s"
    assert entries["k1_prime_share"]["better"] == "lower"
    assert entries["k1_wave_fill"]["better"] == "higher"


def test_readers_find_nothing_without_the_counters(counters):
    counters.count("k1.launch", 3)  # a port counting launches only
    assert k1_prime_share.read(None) is None
    assert k1_wave_fill.read(None) is None


@pytest.mark.parametrize("launches,prime_share,wave_fill", [
    # hydro2d at 10000 x 10000: 132 blocks of 76 rows and 4 priming rows
    ([(132, 1, 1, 10524, 10000)], 100 * (1 - 10000 / 10524), 100.0),
    # 79 blocks of 128 rows and 50 priming rows, on 79 of 132 SMs
    ([(79, 1, 1, 13950, 10000)], 100 * (1 - 10000 / 13950),
     100 * 79 / 132),
    # two launches: their sums
    ([(132, 1, 1, 10524, 10000), (79, 1, 1, 13950, 10000)],
     100 * (1 - 20000 / 24474), 100 * 211 / 264),
    # a batched launch of 21 examples, 3 blocks an SM, 2 waves
    ([(21 * 32, 2, 3, 21 * 3300, 21 * 3200, 21)],
     100 * (1 - 3200 / 3300), 100 * 672 / (2 * 132 * 3))])
def test_readers_read_the_counted_launches(counters, launches, prime_share,
                                           wave_fill):
    from repro_torch.kernels.stencil2d import kernel as k1
    from repro_torch.kernels.stencil2d.emit import CallLayout
    from repro_torch.core import ALL_PROGRAMS, compile_program
    lay = CallLayout(compile_program(
        ALL_PROGRAMS["hydro2d"](), backend="interp_torch",
        device="cpu").kernel_plan.calls[0])
    for args in launches:
        k1.count_launch(lay, _launch(*args))
    assert k1_prime_share.read(None) == pytest.approx(prime_share)
    assert k1_wave_fill.read(None) == pytest.approx(wave_fill)
    assert counters.counter("k1.launch") == len(launches)
