"""The hydro2d configuration and its cell ``hydro2d-step`` on the CPU at
tiny grids: the run is correct and its line has the cell's metrics, the
control and a corrupted output read ``correct`` false, the reference's
row blocks and tie mask, and the two readers of the cell's per-layer
metrics (None where they find nothing to read)."""
import json
import time
import types

import pytest
import torch

from portbench import harness, reference
from portbench.metrics import _yardstick, hydro2d_k1_roofline, k1_local_bytes

CELL = "hydro2d-step"
DIMS = {"Nj": 24, "Ni": 40}
SEED = 2**31 + 29


def run(trace=False, seconds=0.3, **kw):
    return harness.run_cell(CELL, SEED, seconds, trace,
                            t_start=time.perf_counter(), device="cpu",
                            dims=DIMS, **kw)


def config():
    return json.loads((harness.ROOT / "portbench" / "configs" /
                       "hydro2d.json").read_text())


def test_entries_name_the_new_files():
    bench = harness.load_benchmark()
    cell = next(c for c in bench["workloads"] if c["name"] == CELL)
    assert cell["config"] == "hydro2d" and cell["chips"] == 1
    assert cell["traffic"] == "step_hydro2d_10k"
    mix = json.loads((harness.ROOT / "portbench" / "traffic" /
                      "step_hydro2d_10k.json").read_text())
    assert mix["dims"] == {"Nj": 10000, "Ni": 10000} and mix["loop"] == "step"
    per_layer = {m["name"]: m for m in harness.metric_entries(bench, CELL,
                                                              True)}
    assert set(per_layer) == {"hydro2d_k1_roofline", "k1_local_bytes"}
    assert {m["name"] for m in harness.metric_entries(bench, CELL, False)} \
        == {"points_per_s", "setup_s"}
    cfg = config()
    assert cfg["reduced"] == [] and cfg["control"] == {"dtype": "bfloat16"}
    assert set(cfg["inputs"]) == {"rho", "rhou", "rhov", "E"}


def test_sound_run_is_correct():
    line = run()
    assert line["correct"] is True and line["failed"] == 0
    assert set(line["metrics"]) == {"points_per_s", "setup_s"}
    assert line["compared"]["judged"] == 2
    assert line["checks"]["rel_l2"]["value"] <= 1e-6


def test_traced_run_on_the_cpu_reads_no_per_layer_metric():
    """No device trace and no K1 on the CPU: both readers find nothing
    (the counters may hold what other tests of the process loaded, so
    ``k1_local_bytes`` is held to its reading of them)."""
    line = run(trace=True, seconds=0.4)
    assert "hydro2d_k1_roofline" not in line["metrics"]
    assert set(line["metrics"]) <= {"k1_local_bytes"}


def test_control_fails_the_limit():
    line = run(control=True)
    assert line["correct"] is False
    assert line["checks"]["rel_l2"]["value"] > \
        10 * line["checks"]["rel_l2"]["limit"]


def test_a_changed_output_fails(monkeypatch):
    forward = reference.load("hydro2d").forward

    def off(arrays):
        out = forward(arrays)
        out["enew"][5, 7] += 1.0
        return out

    monkeypatch.setattr(reference.load("hydro2d"), "forward", off)
    assert run()["correct"] is False


def test_reference_row_blocks_agree(monkeypatch):
    ref = reference.load("hydro2d")
    g = torch.Generator().manual_seed(4)
    x = torch.randn((4, 23, 17), generator=g, dtype=torch.float64)
    a = {"rho": x[0] ** 2 + 1, "rhou": x[1], "rhov": x[2],
         "E": x[3] ** 2 + 20}
    whole, whole_mask = ref.forward(a), ref.undecided(a)
    monkeypatch.setattr(ref, "BLOCK", 3)
    blocked, blocked_mask = ref.forward(a), ref.undecided(a)
    for k in whole:
        assert torch.equal(whole[k], blocked[k]), k
        assert torch.equal(whole_mask[k], blocked_mask[k]), k


def test_tie_mask_covers_the_reach_of_a_tied_interface(monkeypatch):
    """With every fan sampling tied, every output of the interior is
    undecided and none of the border; with none, none."""
    ref = reference.load("hydro2d")
    g = torch.Generator().manual_seed(6)
    x = torch.randn((4, 15, 16), generator=g, dtype=torch.float64)
    a = {"rho": x[0] ** 2 + 1, "rhou": x[1], "rhov": x[2],
         "E": x[3] ** 2 + 20}
    monkeypatch.setattr(ref, "TIE_RTOL", 1e9)
    mask = ref.undecided(a)["rnew"]
    assert bool(mask[2:-2, 2:-2].all())
    assert not bool(mask[:2].any() or mask[-2:].any()
                    or mask[:, :2].any() or mask[:, -2:].any())
    monkeypatch.setattr(ref, "TIE_RTOL", 0.0)
    assert not bool(ref.undecided(a)["rnew"].any())


def test_roofline_reader_counts_operations_once_a_grid_point():
    cfg = config()
    dims = {"Nj": 10000, "Ni": 10000}
    flops = _yardstick.flops_per_point(reference.load("hydro2d").BODIES)
    least = hydro2d_k1_roofline.least_seconds(cfg, dims, flops,
                                              "NVIDIA H100 80GB HBM3")
    # 1402 operations at each of 9996 x 9996 points at 67 TFLOP/s, over
    # the 3.2 GB of eight 400 MB arrays at 3.35 TB/s (0.955 ms)
    assert least == pytest.approx(1402 * 9996 ** 2 / 67e12)
    assert _yardstick.bytes_moved(cfg, dims) / 3.35e12 < least
    # run.least_s counts them once an output point, four times over
    assert _yardstick.least_seconds(cfg, dims, flops,
                                    "NVIDIA H100 80GB HBM3") == \
        pytest.approx(4 * least)
    assert hydro2d_k1_roofline.least_seconds(cfg, dims, flops, "cpu") is None


def test_roofline_reader_finds_nothing_without_a_trace_or_at_another_grid():
    none = types.SimpleNamespace(trace=None, points=4 * 9996 ** 2)
    assert hydro2d_k1_roofline.read(none) is None
    trace = types.SimpleNamespace(k1_s=1.0, examples=10)
    small = types.SimpleNamespace(trace=trace, points=4 * 20 * 36)
    assert hydro2d_k1_roofline.read(small) is None


def test_local_bytes_reader_reads_the_counters(monkeypatch):
    from repro_torch import obs
    monkeypatch.setattr(obs, "_counts", {})
    assert k1_local_bytes.read(None) is None
    obs.count("k1.attrs", 2)
    obs.count("k1.local_bytes", 100)
    assert k1_local_bytes.read(None) == 50.0


@pytest.mark.cuda
def test_cell_on_the_card_is_correct(cuda_device):
    """A short run at 512 x 768 through K1, traced: correct, both readers
    read (the roofline finds the grid is not the cell's and stays out)."""
    line = harness.run_cell(CELL, SEED, 0.5, True,
                            t_start=time.perf_counter(), device=cuda_device,
                            dims={"Nj": 512, "Ni": 768})
    assert line["correct"] is True
    assert "k1_local_bytes" in line["metrics"]
