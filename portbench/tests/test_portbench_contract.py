"""``BENCHMARK.json`` against the benchmark's contract, and every name in
it, and in the cells held out of it (``held.json``), against the file
that serves it."""
import importlib
import json
import re

import pytest

from portbench import draws, generator, loops, metrics
from portbench.harness import ROOT, load_benchmark, with_held

BENCH = load_benchmark()
#: BENCHMARK.json with the held cells: each must stay ready to go back in.
HELD = with_held(BENCH)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_names_units_and_lines():
    names = [c["name"] for c in BENCH["configs"]] + \
        [c["name"] for c in BENCH["workloads"]] + [m["name"] for m in METRICS]
    assert all(NAME.match(n) for n in names)
    for group in (BENCH["configs"], BENCH["workloads"], METRICS):
        assert len({g["name"] for g in group}) == len(group)
    assert all(UNIT.match(m["unit"]) for m in METRICS)
    assert all(m["better"] in ("lower", "higher") for m in METRICS)
    for text in [c["why"] for c in BENCH["configs"] + BENCH["workloads"]] + \
            [m["layer"] for m in BENCH["per_layer"]]:
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


@pytest.mark.parametrize("entry", HELD["configs"], ids=lambda c: c["name"])
def test_config_files(entry):
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    assert entry["file"].startswith("portbench/configs/")
    cfg = json.loads((ROOT / entry["file"]).read_text())
    assert cfg["name"] == entry["name"]
    assert cfg["source"] == entry["source"]
    assert cfg["reduced"] == entry["reduced"] == []
    assert 0 < cfg["limits"]["rel_l2"] < 1e-3
    ref = importlib.import_module(f"portbench.reference.{entry['name']}")
    assert callable(ref.forward) and ref.BODIES


@pytest.mark.parametrize("cell", HELD["workloads"], ids=lambda c: c["name"])
def test_cells(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert cell["chips"] == 1
    assert 1 <= len(cell["why"]) <= 200
    assert cell["config"] in {c["name"] for c in HELD["configs"]}
    mix = generator.load_mix(cell["traffic"])
    assert callable(loops.load(mix["loop"]))
    cfg = json.loads((ROOT / "portbench" / "configs" /
                      f"{cell['config']}.json").read_text())
    assert all(callable(draws.load(a["draw"])) for a in cfg["inputs"].values())
    wanted = {d for a in cfg["inputs"].values() for d in a["dims"]}
    assert set(mix["dims"]) == wanted
    reported = [m for m in HELD["end_to_end"] + HELD["per_layer"]
                if cell["name"] in m.get("workloads", [cell["name"]])]
    ends = {m["name"] for m in reported if m in HELD["end_to_end"]}
    assert "setup_s" in ends and len(ends) >= 2
    assert any(m in HELD["per_layer"] for m in reported)


def test_pairs_appear_once():
    pairs = [(c["config"], c["traffic"]) for c in HELD["workloads"]]
    assert len(set(pairs)) == len(pairs)


def test_held_cells_are_not_in_the_benchmark():
    names = {c["name"] for c in BENCH["workloads"]}
    held = HELD["workloads"][len(BENCH["workloads"]):]
    assert held and not names & {c["name"] for c in held}
    assert not {c["name"] for c in BENCH["configs"]} & \
        {c["name"] for c in HELD["configs"][len(BENCH["configs"]):]}
    # every configuration in BENCHMARK.json is used by one of its cells
    assert {c["name"] for c in BENCH["configs"]} == \
        {c["config"] for c in BENCH["workloads"]}


@pytest.mark.parametrize("m", METRICS, ids=lambda m: m["name"])
def test_every_metric_has_its_reader(m):
    assert callable(metrics.load(m["name"]).read)


@pytest.mark.parametrize("m", BENCH["end_to_end"], ids=lambda m: m["name"])
def test_end_to_end_bounds(m):
    assert set(m) <= {"name", "unit", "better", "bound", "source",
                      "workloads"}
    assert m["source"] in ("host_clock", "device_trace")
    assert 0.01 <= m["bound"] <= 0.25


@pytest.mark.parametrize("m", BENCH["per_layer"], ids=lambda m: m["name"])
def test_per_layer_moves_a_metric_its_cells_report(m):
    assert set(m) == {"name", "unit", "better", "source", "layer", "moves",
                      "workloads"}
    assert m["source"] in ("device_trace", "program_span", "program_counter",
                           "host_clock")
    end = next(e for e in BENCH["end_to_end"] if e["name"] == m["moves"])
    cells = {c["name"] for c in BENCH["workloads"]}
    assert set(m["workloads"]) <= cells
    assert set(m["workloads"]) <= set(end.get("workloads", cells))
    if m["name"].endswith("_roofline") or "mfu" in m["name"]:
        assert m["unit"] == "%"
