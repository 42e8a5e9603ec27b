#!/usr/bin/env python3
"""Time the stencil kernel K1 alone under two row decompositions of one
launch, on one CUDA device, and check that their outputs agree bit for
bit.

    python3 scripts/k1_decomposition.py [--out FILE]

``derived`` is the program's own launch: the row prime read from the
plan (``CallLayout._row_reach``, the longest chain of reads back through
the rolling windows) and a chunk length for any count of chunks.
``summed`` is the decomposition the kernel took before: the prime the sum
of every rolling window's stages, and the chooser's lengths only powers of
two and the whole range (the same scoring of waves times walk).  It is
built in this script alone: ``CallLayout._row_reach`` is replaced while
its kernel is emitted and its launch fixed.

Cases: hydro2d at 10000 x 10000, cosmo at COSMO-1's 80 x 774 x 1158, and
cosmo at COSMO-E's bucket 64 x 416 x 608 batched 21 (one launch of the
batched kernel).  Each time is ``bench.kernel_ms`` (device time, the L2
flushed before each run, median), taken in the order derived, summed,
summed, derived.  Prints one JSON line a launch and a last line with the
card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
CASES = (("hydro2d", {"j": 10000, "i": 10000}, 0),
         ("cosmo", {"k": 80, "j": 774, "i": 1158}, 0),
         ("cosmo", {"k": 64, "j": 416, "i": 608}, 21))


def summed_launch(emit, k1, call, sizes, seated, sms, batch):
    """The launch the kernel took with the summed prime and power-of-two
    chunks: ``(lib, layout, launch)``, its kernels built with the summed
    prime (with ``batch``, the batched kernel and its launch)."""
    real = emit.CallLayout._row_reach
    emit.CallLayout._row_reach = lambda self: sum(w.stages
                                                  for w in self.roll_wins)
    k1._CALLS.clear()
    try:
        lay = k1.layout(call, torch.float32, seated)
        lib = k1.build_library(call, torch.float32, bool(batch), seated)
        resident = k1.occupancy(k1.build_library(call, torch.float32,
                                                 False, seated))
        steps_j = sizes[-2] + call.x_hi_off - call.x_lo
        cands = sorted({steps_j} | {1 << e for e in range(steps_j.bit_length())
                                    if 1 << e < steps_j})
        best = None
        for c in cands:
            run = lay.concretize(sizes, resident, c, sms)
            fast = dict(zip(lay.int_names, run.ints))["fast_floats"]
            if run.resident < 1 or (not run.smem_bytes and run.nblocks * fast
                                    * 4 > emit.MAX_GLOBAL_SCRATCH):
                continue
            walk = min(run.chunk_len + lay.prime, run.steps_j)
            key = (not run.smem_bytes, run.waves * walk, run.nblocks * walk,
                   -run.nblocks)
            if best is None or key < best[0]:
                best = (key, run)
        run = best[1]
        if batch:
            run = k1.batch_launch(lay, run, batch, sms)
        return lib, lay, run
    finally:
        emit.CallLayout._row_reach = real
        k1._CALLS.clear()


def describe(name, dims, batch, tag, lay, run, ms) -> dict:
    return {"case": name, "dims": dims, "batch": batch, "decomposition": tag,
            "prime": lay.prime, "blocks": run.nblocks,
            "chunk_len": run.chunk_len,
            "walk": min(run.chunk_len + lay.prime, run.steps_j),
            "resident": run.resident, "waves": run.waves,
            "smem_bytes": run.smem_bytes, "rows_walked": run.rows_walked,
            "rows_owned": run.rows_owned,
            "prime_share": 100 * (1 - run.rows_owned / run.rows_walked),
            "wave_fill": 100 * run.nblocks / (run.waves * run.sms
                                              * run.resident),
            "kernel_ms": ms}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k1_decomposition: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core import ALL_PROGRAMS, compile_batched, \
        compile_program
    from repro_torch.kernels.stencil2d import bench, emit
    from repro_torch.kernels.stencil2d import kernel as k1

    dev = torch.device("cuda", 0)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    flush = bench.l2_flusher(dev)
    out = open(args.out, "w") if args.out else None
    ok = True
    for name, dims, batch in CASES:
        prog = ALL_PROGRAMS[name]()
        if batch:
            gen = compile_batched(prog, "cuda")
            plan = gen.gen.kernel_plan
            parts = [bench.make_inputs(name, plan, dims, 11 + b, dev)
                     for b in range(batch)]
            arrs = {k: torch.stack([p[k] for p in parts]) for k in parts[0]}
            _, records = bench.capture(lambda: gen.fn(arrs))
        else:
            gen = compile_program(prog, "cuda")
            arrs = bench.make_inputs(name, gen.kernel_plan, dims, 11, dev)
            _, records = bench.capture(lambda: gen.fn(**arrs))
        (lib, lay, run, inputs), = records
        sizes = run.sizes
        s_lib, s_lay, s_run = summed_launch(emit, k1, lay.call, sizes,
                                            bool(lay.seated_outs), sms,
                                            batch)
        stream = torch.cuda.current_stream(dev).cuda_stream
        got = k1.run_kernel(lib, lay, run, inputs, threads=run.threads,
                            stream=stream)
        ref = k1.run_kernel(s_lib, s_lay, s_run, inputs,
                            threads=s_run.threads, stream=stream)
        got = got if isinstance(got, list) else [got]
        ref = ref if isinstance(ref, list) else [ref]
        same = all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                   for a, b in zip(got, ref))
        ok &= same
        del got, ref
        times = {"derived": [], "summed": []}
        for tag in ("derived", "summed", "summed", "derived"):
            rec = (lib, lay, run, inputs) if tag == "derived" else \
                (s_lib, s_lay, s_run, inputs)
            times[tag].append(bench.kernel_ms(rec, flush))
        for tag, (lay_, run_) in (("derived", (lay, run)),
                                  ("summed", (s_lay, s_run))):
            line = describe(name, dims, batch, tag, lay_, run_, times[tag])
            line["bit_identical"] = same
            print(json.dumps(line), flush=True)
            if out:
                out.write(json.dumps(line) + "\n")
        del records, inputs, arrs, gen
        torch.cuda.empty_cache()
    smi = bench.smi_line()
    print(json.dumps({"card": smi, "torch": torch.__version__,
                      "ok": ok}), flush=True)
    if out:
        out.write(json.dumps({"card": smi, "ok": ok}) + "\n")
        out.close()
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
