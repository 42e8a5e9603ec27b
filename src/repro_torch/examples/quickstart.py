"""HFAV quickstart on the port: declare kernels -> infer dataflow -> fuse
-> run (the port of the reference's ``examples/quickstart.py``).

The 5-point Laplace stencil of the paper's Listing 1/Fig. 2, driven
through the whole engine and the port's backends: the fused-source
emitter ``"torch"``, the hand-written CUDA stencil kernel ``"cuda"``
(K1; on the CPU the plain plan interpreter ``"interp_torch"`` stands in
for it) and ``"auto"``.  Runs on the card unless ``--device cpu``::

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""
from __future__ import annotations

import argparse

import numpy as np

from ..core import build_unfused, compile_program, explain
from ..core.interpreters import resolve_device
from ..core.programs import laplace5_program


def plan_dump(prog, device=None) -> str:
    """The rendered KernelPlan ``backend="auto"`` hands the stencil
    kernel, as ``explain(prog, verbose=True)`` appends it after the
    schedule and storage plan."""
    report = explain(prog, verbose=True, device=device)
    return report.split("--- kernel plan ---\n", 1)[1]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="'cpu' to run on the CPU (default: the card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    prog = laplace5_program()

    # `explain` also reports which backend `backend="auto"` picks on
    # this device; verbose=True appends the declarative KernelPlan.
    print("=== transformation report (paper's debugging output) ===")
    print(explain(prog, verbose=True, device=dev))

    # backend="torch": emit fused PyTorch source (inspectable).
    gen = compile_program(prog, backend="torch", device=dev)
    print("\n=== generated PyTorch source (the paper's emitted code) ===")
    print(gen.source)

    rng = np.random.default_rng(0)
    cell = rng.standard_normal((64, 96)).astype(np.float32)
    ref = build_unfused(prog, device=dev).fn(cell=cell)["lap"]
    fused = gen.fn(cell)["lap"]
    err = float((fused - ref).abs().max())
    print(f"=== fused vs unfused max |err| = {err:.2e} ===")
    assert err < 1e-5

    # the stencil kernel: rolling row windows in shared memory, one
    # block per row chunk (K1 on the card; interp_torch on the CPU)
    backend = "cuda" if dev.type == "cuda" else "interp_torch"
    small = cell[:24, :]
    gen_k = compile_program(prog, backend=backend, device=dev)
    kerr = float((gen_k.fn(cell=small)["lap"]
                  - build_unfused(prog, device=dev).fn(cell=small)["lap"])
                 .abs().max())
    print(f"=== {backend} vs unfused max |err| = {kerr:.2e} ===")
    assert kerr < 1e-5

    # backend="auto" (the default): the stencil kernel on the card
    auto_gen = compile_program(prog, device=dev)
    print(f"=== auto picked: {type(auto_gen).__name__} ===")


if __name__ == "__main__":
    main()
