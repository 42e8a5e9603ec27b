"""COSMO diffusion micro-kernels through the port's backends (paper
§5.3; the port of the reference's ``examples/cosmo_fusion.py``).

Shows the fused single-nest schedule, the rolling-buffer storage plan
(ulap 2 rows + fy 2 rows), the fused-source emitter and the stencil
kernel (K1 on the card; the plain plan interpreter ``"interp_torch"``
with ``--device cpu``) against the unfused evaluator::

    PYTHONPATH=src python -m repro_torch.examples.cosmo_fusion [--device cpu]
"""
from __future__ import annotations

import argparse

import numpy as np

from ..core import build_unfused, compile_program, explain
from ..core.interpreters import resolve_device
from ..core.programs import cosmo_program
from ..kernels.stencil2d import run_fused_stencil


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="'cpu' to run on the CPU (default: the card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    prog = cosmo_program()
    print(explain(prog, device=dev))

    gen = compile_program(prog, backend="torch", device=dev)
    rng = np.random.default_rng(0)
    u = rng.standard_normal((4, 48, 160)).astype(np.float32)

    ref = build_unfused(prog, device=dev).fn(u=u)["unew"]
    fused = gen.fn(u)["unew"]
    backend = "cuda" if dev.type == "cuda" else "interp_torch"
    kernel = run_fused_stencil(prog, {"u": u}, device=dev,
                               backend=backend)["unew"]

    e1 = float((fused - ref).abs().max())
    e2 = float((kernel - ref).abs().max())
    print(f"\nPyTorch rolling-buffer emitter  max|err| = {e1:.2e}")
    print(f"stencil kernel ({backend})  max|err| = {e2:.2e}")
    assert e1 < 1e-4 and e2 < 1e-4
    print("\nRolling buffers in the fused nest:")
    for vp in gen.plan.vars.values():
        if vp.kind == "rolling":
            print(f"  {vp.name}: {vp.stages} rows "
                  f"(contraction over {vp.contraction_dim})")


if __name__ == "__main__":
    main()
