#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

Run from the repository root with no arguments::

    python3 chip_smoke.py

It needs one CUDA device and ``nvcc``; without a device (or outside a
checkout of the repository) it exits non-zero and prints no result.
Phases, each of which raises on failure:

1. environment: torch, CUDA and nvcc versions, the card's name and
   power limit;
2. build: every CallPlan of the 15 programs is emitted and built with
   one ``nvcc`` per source, all started together;
3. conformance: all 15 programs on the ``"cuda"`` kernel against the
   plain ``"interp_torch"`` interpreter, both on the card, with a small
   forced row chunk and with the default one;
4. main path at the sizes of the repository's benchmarks:
   ``compile_program(prog)`` (backend ``"cuda"``) on normalization
   (4096 x 2048), hydro1d (2048 x 4096) and cosmo (64 x 512 x 512),
   held against the port's unfused evaluator and the plain interpreter,
   timed by CUDA events (median of 20 runs after warm-up, L2 flushed
   between runs) beside the bytes each call must move and their bound;
   then, the same way, the plane-window programs, whose calls run
   unchunked (heat3d at 6 x 32 x 256 and 64 x 512 x 512, advect4d_halo
   at 4 x 16 x 512 x 512);
5. the ``kernels`` line: per program and size, the kernel's launches in
   one driven run (counted from zero just before it), its error against
   the plain version, its times, its block count and its bound.

The last line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import pathlib
import sys
import time

import torch

ROOT = pathlib.Path(__file__).resolve().parent
ATOL, RTOL = 2e-4, 1e-3
CONFORMANCE_DIMS = {"i": 200, "j": 37, "k": 5, "l": 3}
SMALL_CHUNK = 3
K1_SOURCE = "src/repro_torch/kernels/stencil2d/csrc/stencil2d.cuh"
K1_REPLACES = "src/repro/kernels/stencil2d/kernel.py:95"


def max_err(got: dict, want: dict, tag: str) -> float:
    """Max |got - want| over the goals; raises past the tolerance or on
    a non-finite value."""
    err = 0.0
    for k, w in want.items():
        g = got[k]
        if g.shape != w.shape:
            raise AssertionError(f"{tag}:{k}: shape {tuple(g.shape)} != "
                                 f"{tuple(w.shape)}")
        if not bool(torch.isfinite(g).all()):
            raise AssertionError(f"{tag}:{k}: non-finite values")
        diff = (g - w).abs()
        n_bad = int((diff > ATOL + RTOL * w.abs()).sum())
        if n_bad:
            raise AssertionError(
                f"{tag}:{k}: {n_bad} of {g.numel()} values past atol={ATOL}"
                f" rtol={RTOL} (max abs err {float(diff.max()):.3e})")
        err = max(err, float(diff.max()))
    return err


def drive(n: str, dims: dict, dev, flush, rate: float, smi: str) -> dict:
    """Run ``n`` once through ``compile_program`` (backend ``"cuda"``) at
    ``dims`` with the launch count set to 0 just before, hold it against
    the unfused evaluator and the plain interpreter, time it, and return
    its entry of the ``kernels`` line."""
    from repro_torch.core import ALL_PROGRAMS, build_unfused, compile_program
    from repro_torch.kernels.stencil2d import bench
    from repro_torch.kernels.stencil2d import kernel as k1

    prog = ALL_PROGRAMS[n]()
    gen = compile_program(prog)
    arrs = bench.make_inputs(n, gen.kernel_plan, dims, 11, dev)
    k1.launches = 0
    got, records = bench.capture(lambda: gen.fn(**arrs))
    launches = k1.launches
    if launches == 0:
        raise AssertionError(f"main path {n}: no kernel launch")

    ufn = build_unfused(prog, device=dev).fn
    err_unfused = max_err(got, ufn(**arrs), f"main/{n}/unfused")
    plain = compile_program(prog, backend="interp_torch", device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = plain.fn(**arrs)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    err_plain = max_err(got, want, f"main/{n}/interp_torch")

    fn_ms = bench.event_ms(lambda: gen.fn(**arrs), flush)
    unfused_ms = bench.event_ms(lambda: ufn(**arrs), flush)
    kernel_ms = sum(bench.kernel_ms(r, flush) for r in records)
    nbytes = sum(bench.call_bytes(lay, run, args)
                 for _, lay, run, args in records)
    bound_ms = nbytes / rate * 1e3
    blocks = "+".join(str(run.nblocks) for _, _, run, _ in records)
    shape = tuple(dims.values())
    print(f"main {n:14s} {shape}: launches={launches}  blocks={blocks}  "
          f"err_vs_unfused={err_unfused:.3e}  "
          f"err_vs_plain={err_plain:.3e}  fn_ms={fn_ms:.4f}  "
          f"kernel_ms={kernel_ms:.4f}  unfused_ms={unfused_ms:.4f}  "
          f"plain_ms={plain_ms:.1f}  bytes={nbytes}  "
          f"bound_ms={bound_ms:.4f} (at {rate / 1e12:.2f} TB/s)  "
          f"card: {smi}", flush=True)
    return {
        "name": f"stencil2d[{n} {'x'.join(map(str, shape))}]",
        "route": "cuda", "source": K1_SOURCE, "replaces": K1_REPLACES,
        "launches": launches, "max_abs_err": err_plain,
        "ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": "bytes", "library_ms": None,
        "fn_ms": fn_ms, "unfused_ms": unfused_ms, "blocks": blocks,
    }


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core import ALL_PROGRAMS, compile_program
    from repro_torch.kernels.stencil2d import bench
    from repro_torch.kernels.stencil2d import kernel as k1

    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    smi = bench.smi_line()
    rate = bench.hbm_rate(name)

    # 1. environment
    print(f"env: python {sys.version.split()[0]}  torch {torch.__version__}  "
          f"cuda {torch.version.cuda}  nvcc "
          f"{k1.nvcc_version().strip().splitlines()[-1]}  card: {smi}",
          flush=True)

    # 2. build every kernel of the 15 programs in parallel
    plans = {n: compile_program(b(), backend="interp_torch",
                                device=dev).kernel_plan
             for n, b in sorted(ALL_PROGRAMS.items())}
    calls = [c for kp in plans.values() for c in kp.calls if c.has_grid]
    t0 = time.perf_counter()
    built = k1.build_all(calls)
    print(f"build: {len(calls)} calls, {built} sources compiled in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    # 3. conformance: "cuda" against "interp_torch", both on the card
    for n, b in sorted(ALL_PROGRAMS.items()):
        prog = b()
        arrs = bench.make_inputs(n, plans[n], CONFORMANCE_DIMS, 7, dev)
        want = compile_program(prog, backend="interp_torch",
                               device=dev).fn(**arrs)
        errs = []
        for chunk in (SMALL_CHUNK, None):
            got = compile_program(prog, backend="cuda", device=dev,
                                  chunk=chunk).fn(**arrs)
            torch.cuda.synchronize()
            errs.append(max_err(got, want, f"conformance/{n}/chunk={chunk}"))
        print(f"conformance {n:22s} max_abs_err chunk={SMALL_CHUNK}: "
              f"{errs[0]:.3e}  default chunk: {errs[1]:.3e}", flush=True)

    # 4. the main path at real size, then the unchunked plane-window calls
    flush = bench.l2_flusher(dev)
    entries = [drive(n, dims, dev, flush, rate, smi)
               for n, dims in bench.MAIN_PATH + bench.PLANE_WINDOW_PATH]

    # 5. the kernels line, the card, and the result
    print(json.dumps({"kernels": entries}))
    print(bench.smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
