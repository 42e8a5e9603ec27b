"""Nothing the benchmark runs imports JAX or the JAX package, and the
plain references import nothing of the port."""
import ast
import pathlib

import pytest

PKG = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
MODULES = sorted(p for p in PKG.rglob("*.py") if ".cache" not in p.parts)


def imported(path: pathlib.Path) -> set:
    """Top-level names of every absolute import in ``path``."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_the_walk_sees_every_module():
    rel = {p.relative_to(PKG).as_posix() for p in MODULES}
    assert {"run.py", "harness.py", "generator.py", "trace.py",
            "reference/cosmo.py", "metrics/_yardstick.py"} <= rel


@pytest.mark.parametrize("path", MODULES,
                         ids=[p.relative_to(PKG).as_posix() for p in MODULES])
def test_no_jax_import(path):
    assert not imported(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((PKG / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    assert "repro_torch" not in imported(path)
    assert imported(path) <= {"__future__", "importlib", "torch"}


def test_names_compare_whole():
    from portbench.harness import FORBIDDEN as run_forbidden
    assert set(run_forbidden) == FORBIDDEN
    assert "repro_torch".split(".")[0] not in FORBIDDEN
