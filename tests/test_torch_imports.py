"""The port stands alone: no module of ``repro_torch``, and not
``chip_smoke.py``, imports JAX or the ``repro`` package."""
import ast
import os
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
PKG = ROOT / "src" / "repro_torch"


def _modules() -> list[str]:
    mods = []
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(ROOT / "src").with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        mods.append(".".join(parts))
    return mods


def test_every_module_imports_without_jax_or_repro():
    mods = _modules()
    for sub in ("kernels.stencil2d.kernel", "kernels.build",
                "kernels.flash_attention.kernel",
                "kernels.flash_decode.kernel", "kernels.ssd.kernel",
                "kernels.ssd.ops", "kernels.ssd.ref", "configs.registry",
                "models.lm", "models.ssm", "models.moe", "models.convert",
                "serve.engine", "serve.bench", "serve.plans",
                "serve.workers", "core.codegen_torch", "core.layoutapply",
                "core.plancache", "core.runtime", "core.engine",
                "kernels._grad", "tree", "data.pipeline", "optim.adamw",
                "train.step", "ckpt.checkpoint", "ft.watchdog",
                "launch.train", "scripts.warm_cache", "scripts.plan_lint",
                "examples.quickstart", "examples.cosmo_fusion",
                "examples.serve_lm", "examples.train_lm",
                "roofline.analysis", "roofline.report", "distributed.ctx",
                "distributed.sharding", "distributed.pipeline",
                "launch.mesh", "launch.specs", "launch.dryrun"):
        assert f"repro_torch.{sub}" in mods
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m == 'jax' or m.startswith('jax.')\n"
        "             or m == 'repro' or m.startswith('repro.'))\n"
        "print(len(sys.modules))\n"
        "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=str(ROOT),
                         env={**os.environ,
                              "PYTHONPATH": str(ROOT / "src")})
    assert out.returncode == 0, out.stderr


def test_chip_smoke_imports_neither_jax_nor_repro():
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module)
    roots = {n.split(".")[0] for n in names}
    assert "jax" not in roots and "repro" not in roots, sorted(names)
    assert "repro_torch" in roots
