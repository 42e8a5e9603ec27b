#!/usr/bin/env python3
"""Sweep the launch of the PyTorch/CUDA port's stencil kernel (K1) on one
CUDA device, at the sizes ``chip_smoke.py`` times.

    python3 scripts/stencil_sweep.py

For each K1 call of the main path and the plane-window programs it
times, by CUDA events on the device alone (``bench.kernel_ms``, median
of 20 runs after warm-up, the L2 flushed before each): the default
launch; the launch at 4 and 8 columns a thread
(``emit.COLS_PER_THREAD``, a launch parameter: no rebuild); and, for the
plane-window calls, a grid of forced plane chunks x row tiles.  Beside
them, one PyTorch call over normalization's second call's bytes
(``x * 2`` of a 4096 x 2047 float32 array) as a yardstick of the memory
rate.  Prints one line a launch, then the card's name and power limit.
"""
from __future__ import annotations

import pathlib
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PLANE_CHUNKS = (2, 4, 8, 16)
ROW_TILES = (1, 2, 4, 8, 16)


def line(name: str, dims: dict, tag: str, ms: float, run) -> str:
    return (f"{name:26s} {'x'.join(map(str, dims.values())):12s} "
            f"{tag:18s} kernel_ms={ms:.4f}  blocks={run.nblocks} "
            f"threads={run.threads} tile={run.pchunk_len}x{run.chunk_len} "
            f"resident={run.resident} waves={run.waves} "
            f"smem={run.smem_bytes}")


def main() -> int:
    if not torch.cuda.is_available():
        print("stencil_sweep: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core import ALL_PROGRAMS, compile_program
    from repro_torch.kernels.stencil2d import bench, emit
    from repro_torch.kernels.stencil2d import kernel as k1

    dev = torch.device("cuda", 0)
    flush = bench.l2_flusher(dev)
    x = torch.randn(4096, 2047, device=dev)
    print(f"torch x * 2 (4096x2047 float32): "
          f"{bench.device_ms(lambda: x * 2.0, flush):.4f} ms", flush=True)
    default_cols = emit.COLS_PER_THREAD
    for n, dims in bench.MAIN_PATH + bench.PLANE_WINDOW_PATH:
        gen = compile_program(ALL_PROGRAMS[n]())
        arrs = bench.make_inputs(n, gen.kernel_plan, dims, 11, dev)
        _, records = bench.capture(lambda: gen.fn(**arrs))
        for lib, lay, run, args in records:
            name = lay.call.name
            print(line(name, dims, "default", bench.kernel_ms(
                (lib, lay, run, args), flush), run), flush=True)
            occupancy = k1.occupancy(lib)
            sms = torch.cuda.get_device_properties(dev).multi_processor_count
            try:
                for cols in (4, 8):
                    emit.COLS_PER_THREAD = cols
                    r = lay.concretize(run.sizes, occupancy, sms=sms)
                    print(line(name, dims, f"cols={cols}", bench.kernel_ms(
                        (lib, lay, r, args), flush), r), flush=True)
            finally:
                emit.COLS_PER_THREAD = default_cols
            if not lay.planar or dims["k"] < 16:
                continue
            for pc in PLANE_CHUNKS:
                for rt in ROW_TILES:
                    r = lay.concretize(run.sizes, occupancy, rt, sms, pc)
                    print(line(name, dims, f"tile={pc}x{rt}",
                               bench.kernel_ms((lib, lay, r, args), flush),
                               r), flush=True)
    print(bench.smi_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
