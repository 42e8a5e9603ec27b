"""The port's tooling and examples: ``python -m
repro_torch.scripts.warm_cache`` (golden corpus equal to
``tests/goldens/plans``, a warmed cache that compiles with no analysis),
``python -m repro_torch.scripts.plan_lint`` against the reference's
``scripts/plan_lint.py`` run as a subprocess (the same JSON lines, the
same exit status), and each example of ``repro_torch.examples`` on the
CPU at its smallest arguments."""
from __future__ import annotations

import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.core import (ALL_PROGRAMS, PORT_ONLY, PallasGenerated,
                              PlanCache,
                              build_unfused, clear_compile_cache,
                              compile_program, engine)
from repro_torch.core.plan import PORT_PROGRAMS, REFERENCE_PROGRAMS
from repro_torch.examples import cosmo_fusion, quickstart, serve_lm, train_lm
from repro_torch.scripts import plan_lint, warm_cache

ROOT = pathlib.Path(__file__).resolve().parent.parent
GOLDEN_DIR = ROOT / "tests" / "goldens" / "plans"
PORT_GOLDEN_DIR = ROOT / "tests" / "goldens" / "port_plans"


@pytest.fixture(scope="module")
def warmed(tmp_path_factory):
    """One ``warm_cache --cache-dir --goldens --port-goldens`` run:
    (cache dir, golden dir, exit status, output); the port's own
    programs' goldens beside the golden dir, in ``port_goldens``."""
    import contextlib
    import io

    root = tmp_path_factory.mktemp("warm")
    cache, goldens = root / "cache", root / "goldens"
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = warm_cache.main(["--cache-dir", str(cache), "--goldens",
                              str(goldens), "--port-goldens",
                              str(root / "port_goldens")])
    return cache, goldens, rc, out.getvalue()


def test_warm_cache_goldens_equal_the_corpus(warmed):
    _, goldens, rc, out = warmed
    assert rc == 0, out
    assert {p.name for p in goldens.glob("*.json")} == \
        {p.name for p in GOLDEN_DIR.glob("*.json")} == \
        {f"{n}.json" for n in ALL_PROGRAMS if n not in PORT_ONLY}
    for path in sorted(GOLDEN_DIR.glob("*.json")):
        text = (goldens / path.name).read_text()
        assert f'"module": "{PORT_PROGRAMS}"' in text
        assert text.replace(f'"module": "{PORT_PROGRAMS}"',
                            f'"module": "{REFERENCE_PROGRAMS}"') == \
            path.read_text(), path.name
    port = goldens.parent / "port_goldens"
    assert {p.name for p in port.glob("*.json")} == \
        {p.name for p in PORT_GOLDEN_DIR.glob("*.json")} == \
        {f"{n}.json" for n in PORT_ONLY}
    for path in sorted(PORT_GOLDEN_DIR.glob("*.json")):
        assert (port / path.name).read_text() == path.read_text(), path.name


def test_warmed_cache_compiles_without_analysis(warmed, monkeypatch):
    cache, _, rc, out = warmed
    assert rc == 0 and f"{len(ALL_PROGRAMS)} entr" in out
    assert len(PlanCache(cache)) == len(ALL_PROGRAMS)
    clear_compile_cache()

    def boom(*a, **k):
        raise AssertionError("analysis ran despite a warmed plan cache")

    monkeypatch.setattr(engine, "infer", boom)
    monkeypatch.setattr(engine, "plan_pallas", boom)
    monkeypatch.setattr(engine, "_build_plan", boom)
    prog = ALL_PROGRAMS["laplace5"]()
    gen = compile_program(prog, backend="interp_torch", device="cpu",
                          plan_cache_dir=cache)
    assert isinstance(gen, PallasGenerated) and gen.plan is None
    u = np.random.default_rng(0).standard_normal((8, 12)).astype(np.float32)
    monkeypatch.undo()
    want = build_unfused(prog, device="cpu").fn(cell=u)["lap"]
    np.testing.assert_allclose(gen.fn(cell=u)["lap"].numpy(), want.numpy(),
                               atol=1e-5, rtol=1e-5)
    clear_compile_cache()


def test_warm_cache_needs_a_target(capsys):
    with pytest.raises(SystemExit):
        warm_cache.main([])
    assert "nothing to do" in capsys.readouterr().err


@pytest.mark.parametrize("flags", [[], ["--strict"], ["--vec"],
                                   ["--vec", "--strict"],
                                   ["--vec", "--apply-layout", "force"]])
def test_plan_lint_matches_the_reference_script(flags, capsys, monkeypatch):
    """The reference script as a subprocess, the port's in process (from
    the repository root, so both print the same relative targets)."""
    args = ["--format", "json", *flags,
            str(GOLDEN_DIR.relative_to(ROOT))]
    ref = subprocess.run(
        [sys.executable, "scripts/plan_lint.py", *args], capture_output=True,
        text=True, cwd=str(ROOT),
        env={**os.environ, "PYTHONPATH": str(ROOT / "src"),
             "JAX_PLATFORMS": "cpu"})
    want = [json.loads(line) for line in ref.stdout.splitlines()]
    monkeypatch.chdir(ROOT)
    capsys.readouterr()
    rc = plan_lint.main(args)
    got = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert len(got) == len(list(GOLDEN_DIR.glob("*.json")))
    assert got == want
    assert rc == ref.returncode


def test_plan_lint_reads_both_entry_forms_and_programs(tmp_path, capsys):
    """A golden file, a reference plan-cache entry (``jax``/``repro``
    header), the port's own entry, a program by name, a directory, and
    a broken file (PC000)."""
    golden = json.loads((GOLDEN_DIR / "cosmo.json").read_text())
    (tmp_path / "ref_entry.json").write_text(json.dumps(
        {"jax": "0.9.0", "repro": "x", "plan": golden}))
    port_cache = tmp_path / "cache"
    compile_program(ALL_PROGRAMS["laplace5"](), backend="interp_torch",
                    device="cpu", plan_cache_dir=port_cache, use_cache=False)
    (tmp_path / "broken.json").write_text("{")
    rc = plan_lint.main([str(GOLDEN_DIR / "cosmo.json"),
                         str(tmp_path / "ref_entry.json"), str(port_cache),
                         "heat3d", "--format", "json"])
    records = [json.loads(line)
               for line in capsys.readouterr().out.splitlines()]
    assert rc == 0 and len(records) == 4
    assert records[0]["diagnostics"] == records[1]["diagnostics"]
    assert all(r["errors"] == 0 for r in records)
    assert plan_lint.main([str(tmp_path / "broken.json"), "nope"]) == 1
    out = capsys.readouterr().out
    assert out.count("PC000") == 2


def test_plan_lint_vec_baseline_goes_only_where_told(tmp_path, capsys):
    baseline = ROOT / "tests" / "goldens" / "vec_lint_baseline.json"
    before = baseline.read_text()
    path = tmp_path / "baseline.json"
    assert plan_lint.main(["--update-vec-baseline", str(path),
                           "--apply-layout", "force"]) == 0
    errors = json.loads(path.read_text())["errors"]
    assert errors == json.loads(before)["errors"]
    assert baseline.read_text() == before


def test_quickstart_example(capsys):
    quickstart.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "fused vs unfused max |err|" in out and "auto picked" in out
    assert "kernel plan: laplace5" in quickstart.plan_dump(
        ALL_PROGRAMS["laplace5"](), device="cpu")


def test_cosmo_fusion_example(capsys):
    cosmo_fusion.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "ulap_u: 2 rows" in out and "fy_u: 2 rows" in out


def test_serve_lm_example(capsys):
    serve_lm.main(["--device", "cpu"])
    assert "decode path matches teacher-forced forward" in \
        capsys.readouterr().out


def test_train_lm_example(capsys):
    train_lm.main(["--device", "cpu", "--d-model", "64", "--layers", "2",
                   "--steps", "20", "--batch", "4", "--seq", "32"])
    out = capsys.readouterr().out
    assert "over 20 steps" in out


def test_examples_need_a_card_unless_told(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for example in (quickstart, cosmo_fusion, serve_lm, train_lm):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            example.main([])
