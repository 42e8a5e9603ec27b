"""The hydroc configuration and its cell ``hydroc-sedov`` on the CPU at
small grids: the march is correct and its line has the cell's metrics;
the control, a changed output and a wall that leaks read ``correct``
false; the reference's row blocks; the three readers of the cell's
per-layer metrics on hand-made traces (None where they find nothing to
read); and the new entries and the files they name."""
import json
import re
import time
import types

import pytest
import torch

from portbench import harness, loops, reference
from portbench.metrics import (_yardstick, courant_roofline, hydroc_aux_us,
                               hydroc_k1_roofline)

CELL = "hydroc-sedov"
DIMS = {"Nj": 24, "Ni": 40}
SEED = 2**31 + 41
H100 = "NVIDIA H100 80GB HBM3"
GRID = {"Nj": 10000, "Ni": 10000}


def run(trace=False, seconds=0.3, **kw):
    return harness.run_cell(CELL, SEED, seconds, trace,
                            t_start=time.perf_counter(), device="cpu",
                            dims=DIMS, **kw)


def config():
    return json.loads((harness.ROOT / "portbench" / "configs" /
                       "hydroc.json").read_text())


def march(dims, pairs, dtype=torch.float32):
    """The cell's loop on the CPU at ``dims``, warmed and ``pairs`` more
    pairs marched; returns the loop."""
    from portbench import generator
    cfg = config()
    fields = generator.make_fields(cfg, dims, SEED, 1, 1, "cpu")
    loop = loops.load("march")(None, cfg, generator.load_mix(
        "march_hydroc_sedov_10k"), fields, torch.device("cpu"), dtype)
    loop.warm()
    for _ in range(pairs):
        loop.pair()
    return loop


def test_entries_name_the_new_files():
    bench = harness.load_benchmark()
    cell = next(c for c in bench["workloads"] if c["name"] == CELL)
    assert cell["config"] == "hydroc" and cell["chips"] == 1
    assert cell["traffic"] == "march_hydroc_sedov_10k"
    entry = next(c for c in bench["configs"] if c["name"] == "hydroc")
    assert entry["file"] == "portbench/configs/hydroc.json"
    assert entry["reduced"] == [] == config()["reduced"]
    mix = json.loads((harness.ROOT / "portbench" / "traffic" /
                      "march_hydroc_sedov_10k.json").read_text())
    assert mix["dims"] == GRID and mix["loop"] == "march"
    assert mix["fields"] == 1
    per_layer = {m["name"]: m for m in harness.metric_entries(bench, CELL,
                                                              True)}
    assert set(per_layer) == {"hydroc_k1_roofline", "courant_roofline",
                              "hydroc_aux_us"}
    assert all(m["workloads"] == [CELL] and m["moves"] == "points_per_s"
               for m in per_layer.values())
    assert {m["name"] for m in harness.metric_entries(bench, CELL, False)} \
        == {"points_per_s", "setup_s"}
    cfg = config()
    assert cfg["program"] == "hydroc" and cfg["dtype"] == "float32"
    assert cfg["control"] == {"dtype": "bfloat16"}
    assert {k: v["draw"] for k, v in cfg["inputs"].items()} == {
        "rho": "sedov_density", "rhou": "sedov_momentum",
        "rhov": "sedov_momentum", "E": "sedov_energy"}
    assert all("recalled" in a or "assumed" in a or "float32" in a
               or "one card" in a or "dx" in a for a in cfg["assumed"])
    assert hasattr(reference.load("hydroc"), "undecided")
    assert loops.load("march").__module__ == "portbench.loops.march"


def test_sedov_start():
    from portbench import generator
    f, = generator.make_fields(config(), DIMS, SEED, 1, 1, "cpu")[0]
    assert bool((f["rho"] == 1).all() and (f["rhou"] == 0).all()
                and (f["rhov"] == 0).all())
    e = f["E"].clone()
    assert float(e[2, 2]) == pytest.approx(36.0 ** 2)
    e[2, 2] = 1e-5
    assert bool((e == torch.tensor(1e-5)).all())


def test_sound_run_is_correct():
    line = run()
    assert line["correct"] is True and line["failed"] == 0
    assert set(line["metrics"]) == {"points_per_s", "setup_s"}
    assert line["attempted"] % 2 == 0      # whole pairs
    assert line["compared"]["judged"] == 2
    assert line["checks"]["rel_l2"]["value"] <= 1e-6


def test_traced_run_on_the_cpu_reads_no_per_layer_metric():
    line = run(trace=True, seconds=0.6)
    assert line["correct"] is True
    assert line["metrics"] == {}


def test_control_fails_the_limit():
    line = run(control=True)
    assert line["correct"] is False
    assert line["checks"]["rel_l2"]["value"] > \
        10 * line["checks"]["rel_l2"]["limit"]


def test_a_changed_output_fails(monkeypatch):
    judged = loops.load("march").judged

    def off(self):
        got = judged(self)
        got[0][1]["rnew"][-5, -7] += 1e-3
        return got

    monkeypatch.setattr(loops.load("march"), "judged", off)
    assert run()["correct"] is False


def test_a_leaking_wall_fails_the_conservation_check(monkeypatch):
    """A refill that copies the normal momentum, where a wall negates it,
    lets mass and energy through the walls: the totals part from the
    start's beyond the limit."""
    from repro_torch.core import hydroc
    limit = config()["limits"]["rel_l2"]
    sound = march({"Nj": 20, "Ni": 20}, 6)
    cmp = harness.compare(reference.load("hydroc"), sound.judged()[1:])
    assert cmp["rel_l2"] <= limit / 10

    def leaky(state):
        nj, ni = state["rho"].shape
        for axis, n in ((0, nj), (1, ni)):
            dst, src = hydroc._frame(n, state["rho"].device)
            for x in state.values():
                x.index_copy_(axis, dst, x.index_select(axis, src))
        return state

    monkeypatch.setattr(hydroc, "reflect", leaky)
    leak = march({"Nj": 20, "Ni": 20}, 6)
    cmp = harness.compare(reference.load("hydroc"), leak.judged()[1:])
    assert cmp["rel_l2"] > 10 * limit


def test_reference_row_blocks_agree(monkeypatch):
    ref = reference.load("hydroc")
    g = torch.Generator().manual_seed(4)
    x = torch.randn((4, 23, 17), generator=g, dtype=torch.float64)
    a = ref.reflect({"rho": x[0] ** 2 + 1, "rhou": x[1].clone(),
                     "rhov": x[2].clone(), "E": x[3] ** 2 + 20})
    a["nstep"] = torch.tensor(4.0)
    whole, whole_mask = ref.forward(a), ref.undecided(a)
    monkeypatch.setattr(reference.load("hydro2d"), "BLOCK", 3)
    blocked, blocked_mask = ref.forward(a), ref.undecided(a)
    for k in whole:
        assert torch.equal(whole[k], blocked[k]), k
    for k in whole_mask:
        assert torch.equal(whole_mask[k], blocked_mask[k]), k


def test_reference_totals_and_halved_first_step():
    ref = reference.load("hydroc")
    g = torch.Generator().manual_seed(9)
    x = torch.randn((4, 14, 18), generator=g, dtype=torch.float64)
    a = ref.reflect({"rho": x[0] ** 2 + 1, "rhou": x[1].clone(),
                     "rhov": x[2].clone(), "E": x[3] ** 2 + 20})
    t = ref.forward(a)
    assert set(t) == {"mass", "energy"} and ref.undecided(a) == {}
    assert float(t["mass"]) == pytest.approx(
        float(a["rho"][2:-2, 2:-2].sum()), rel=1e-15)
    first = ref.forward({**a, "nstep": torch.tensor(0.0)})["dtdx"]
    later = ref.forward({**a, "nstep": torch.tensor(2.0)})["dtdx"]
    assert float(first) == pytest.approx(0.5 * float(later), rel=1e-15)


def test_least_times():
    cfg = config()
    flops = _yardstick.flops_per_point(reference.load("hydroc").BODIES)
    # the hydro2d step's 1,402 and the two bounds of each trace, -+100 /
    # dtdx, now computed from the step's dtdx
    assert flops == 1406
    courant = hydroc_k1_roofline.courant_least_seconds(cfg, GRID, H100)
    # four 400 MB fields at 3.35 TB/s
    assert courant == pytest.approx(4 * 4e8 / 3.35e12)
    step = hydroc_k1_roofline.step_least_seconds(cfg, GRID, flops, H100)
    assert step == pytest.approx(1406 * 9996 ** 2 / 67e12 + courant / 2)
    assert hydroc_k1_roofline.step_least_seconds(cfg, GRID, flops,
                                                 "cpu") is None
    assert hydroc_k1_roofline.courant_least_seconds(cfg, GRID, "cpu") is None


def _on_an_h100(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *_: H100)


def _trace(**kw):
    base = dict(k1_s=2.0, other_s=0.004, busy_s=2.01, window_s=2.02,
                examples=40, by_name={courant_roofline.KERNEL: 0.02,
                                      "hfav_kernel(hfav::Params<11, 59, "
                                      "float>)": 1.98})
    return types.SimpleNamespace(**{**base, **kw})


def test_readers_on_a_hand_made_trace(monkeypatch):
    _on_an_h100(monkeypatch)
    cfg = config()
    points = _yardstick.points(cfg, GRID)
    run_ = types.SimpleNamespace(trace=_trace(), points=points)
    flops = _yardstick.flops_per_point(reference.load("hydroc").BODIES)
    step = hydroc_k1_roofline.step_least_seconds(cfg, GRID, flops, H100)
    assert hydroc_k1_roofline.read(run_) == pytest.approx(
        40 * step / 2.0 * 100)
    courant = hydroc_k1_roofline.courant_least_seconds(cfg, GRID, H100)
    assert courant_roofline.read(run_) == pytest.approx(
        20 * courant / 0.02 * 100)
    assert hydroc_aux_us.read(run_) == pytest.approx(0.004 / 40 * 1e6)


def test_readers_find_nothing_without_their_data(monkeypatch):
    points = _yardstick.points(config(), GRID)
    readers = (hydroc_k1_roofline, courant_roofline, hydroc_aux_us)
    # no trace
    for r in readers:
        assert r.read(types.SimpleNamespace(trace=None,
                                            points=points)) is None
    # no card (the CPU)
    bare = types.SimpleNamespace(trace=_trace(), points=points)
    assert hydroc_k1_roofline.read(bare) is None
    assert courant_roofline.read(bare) is None
    _on_an_h100(monkeypatch)
    # another grid
    small = types.SimpleNamespace(trace=_trace(), points=4 * 20 * 36)
    for r in readers:
        assert r.read(small) is None
    # no K1 time, no Courant launch, no step completed
    assert hydroc_k1_roofline.read(types.SimpleNamespace(
        trace=_trace(k1_s=0.0), points=points)) is None
    assert courant_roofline.read(types.SimpleNamespace(
        trace=_trace(by_name={}), points=points)) is None
    for r in readers:
        assert r.read(types.SimpleNamespace(
            trace=_trace(examples=0), points=points)) is None
    # an unknown card
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *_: "GPU")
    assert hydroc_k1_roofline.read(bare) is None
    assert courant_roofline.read(bare) is None


def test_courant_kernel_is_named_apart_from_the_sweeps():
    """The trace names a K1 launch by its parameter block,
    ``Params<NP, ND, T>``: the Courant program's differs from both
    sweeps', which are alike."""
    from repro_torch.core import ALL_PROGRAMS, compile_program
    from repro_torch.core.hydro2d import hydroc_program
    from repro_torch.kernels.stencil2d.emit import emit_source

    def name(prog):
        call, = compile_program(prog, backend="interp_torch",
                                device="cpu").kernel_plan.calls
        src = emit_source(call, torch.float32, seated=True)
        np_, nd = (re.search(rf"#define HFAV_{k} (\d+)", src).group(1)
                   for k in ("NP", "ND"))
        return f"hfav_kernel(hfav::Params<{np_}, {nd}, float>)"

    assert name(ALL_PROGRAMS["courant"]()) == courant_roofline.KERNEL
    xy = name(ALL_PROGRAMS["hydroc"]())
    assert xy == name(hydroc_program("hydroc_yx", "yx"))
    assert xy != courant_roofline.KERNEL


@pytest.mark.cuda
def test_cell_on_the_card_is_correct(cuda_device):
    """A short run at 512 x 768 through K1, traced: correct; the
    readers find the grid is not the cell's and stay out."""
    line = harness.run_cell(CELL, SEED, 0.5, True,
                            t_start=time.perf_counter(), device=cuda_device,
                            dims={"Nj": 512, "Ni": 768})
    assert line["correct"] is True
    assert line["metrics"] == {}
