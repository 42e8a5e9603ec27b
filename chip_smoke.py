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
   one ``nvcc`` per source, all started together; the tensor-core
   instructions of K2's and K4's libraries are counted (``cuobjdump
   -sass``, HMMA), and the run fails if either has none;
3. conformance: all 15 programs on the ``"cuda"`` kernel against the
   plain ``"interp_torch"`` interpreter, both on the card, with a small
   forced row chunk and with the default one; the four plane-window
   programs also with small forced plane chunks and row tiles (one that
   does not divide the planes, and 1 x 1);
4. main path at the sizes of the repository's benchmarks:
   ``compile_program(prog)`` (backend ``"cuda"``) on normalization
   (4096 x 2048), hydro1d (2048 x 4096) and cosmo (64 x 512 x 512),
   held against the port's unfused evaluator and the plain interpreter,
   timed by CUDA events (median of 20 runs after warm-up, L2 flushed
   between runs) beside the bytes each call must move and their bound,
   with each call's launch (blocks, tiles, shared memory), the built
   kernel's registers and local bytes (``cuobjdump -res-usage``), the
   blocks an SM holds of it (its occupancy query), the waves of its grid
   and the barriers of its row step; a second run must give the same
   bits (the device fold of accumulator partials is ordered);
   then, the same way, the plane-window programs, whose calls run in
   plane chunks times row tiles (heat3d at 6 x 32 x 256 and 64 x 512 x
   512, heat3d_stage and heat3d_residual_norm at 64 x 512 x 512,
   advect4d_halo at 4 x 16 x 512 x 512);
4b. the compiler's entry points and PlanServe, each through K1: the
   backend ``"auto"`` picks for each of the 15 programs, without and
   with ``dim_sizes`` at main-path size (every program, split ones
   included, must take ``"cuda"`` and launch K1), with K1's per-block
   bytes at that size; the fused-source emitter (``backend="torch"``)
   on all 15 programs against ``interp_torch`` on the card, then
   normalization and smooth_norm at 4096 x 2048 timed on the emitter
   and on K1 (median of 5), and K1 against the emitter where the
   reference's size consult would route away (a block's region over
   shared memory, rows under the lane-occupancy floor); LayoutApply (``apply_layout="auto"``/``"force"``) on
   ``interp_torch`` for cosmo, hydro1d, laplace5 and row_sum, the
   bit-exact rewrites held bit for bit; the on-disk plan cache (a warm
   compile runs no ``infer``, same bits, cold and warm compile times);
   ``compile_batched`` on K1 at B = 4 for hydro1d and cosmo, bit for bit
   against four single calls, timed both ways; PlanServe on K1 with 48
   requests of mixed sizes over laplace5, hydro1d, normalization and
   cosmo, every answer bit for bit against a per-example K1 call at its
   true size, with its metrics; then two spawned workers over one
   plan-cache directory, cold and then warm, their answers checked the
   same way;
5. attention conformance: flash attention (K2) and flash decode (K3)
   against their plain versions on the card, float32 and bf16, causal
   or not, with and without a window, GQA groups 1, 2 and 4, head dims
   64, 80 and 128, ragged sequence lengths and ragged, windowed cache
   lengths;
6. the LM main path at full width: qwen3-0.6b in bf16 with
   ``attn_impl="pallas"``, random weights from a seeded generator on the
   card.  Prefill of 4 prompts of 2048 tokens (K2 launched 28 times),
   then ``greedy_decode`` of 4 sequences from 16-token prompts for 16
   steps over bf16 caches of 4096 positions (K3 launched 28 x 31 times),
   each held against the plain path (``attn_impl="reference"``) on the
   same weights and tokens, and the float32 prefill against
   ``"chunked"``, then timed;
   K2 and K3 alone at the prefill shape and at a full 4096-position
   cache, beside their plain versions, their bounds, one
   ``scaled_dot_product_attention`` call as a yardstick and the times
   that the kernels they replaced took in an earlier run; K3 again at
   the main path's lengths (31 of 4096), with the split blocks it
   launched and those that held keys;
7. SSD conformance: the SSD chunked scan (K4) against its plain version
   ``ssd_scan`` on the card, x in float32 and bf16, (N, P) = (128, 64)
   and (64, 64), chunks of 256 and 64, sequences that are a multiple of
   the chunk and that are not, B = 1 and 4, and decays that underflow;
8. the SSM main paths at full width in bf16 with ``attn_impl="pallas"``:
   mamba2-130m at full depth (24 layers; prefill of 4 x 2048 launches
   K4 24 times) and zamba2-2.7b cut to 12 layers (two shared-attention
   groups; prefill launches K4 12 times and K2 twice, each decode step
   K3 twice).  Every kernel call of the driven runs is held against its
   plain version on its own inputs; the logits against the plain path
   (``"chunked"``), float32 gated and bf16 printed; greedy decode as for
   qwen3-0.6b; then timed, profiled, and K4 (and zamba2's K2 and K3)
   alone at the path's shapes;
9. the ``kernels`` line: for each kernel and main path (K1's
   ``compile_batched`` and PlanServe paths of phase 4b among them), its
   launches in one driven run (counts set to zero just before it), its
   error against the plain version, its times and its bound.

Every kernel time (``ms``, ``plain_ms``, ``library_ms``) is the
device's alone: the host enqueues the call while the device spins
(``bench.device_ms``).  The end-to-end times (``fn_ms``, prefill, decode
step) include the host's launches (``bench.event_ms``).

The last line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import itertools
import json
import pathlib
import sys
import time

import torch

ROOT = pathlib.Path(__file__).resolve().parent
ATOL, RTOL = 2e-4, 1e-3
CONFORMANCE_DIMS = {"i": 200, "j": 37, "k": 5, "l": 3}
SMALL_CHUNK = 3
#: Plane chunks forced on the plane-window programs at conformance size
#: (2 does not divide k = 5).
SMALL_PLANE_CHUNK = 2
K1_SOURCE = "src/repro_torch/kernels/stencil2d/csrc/stencil2d.cuh"
K1_REPLACES = "src/repro/kernels/stencil2d/kernel.py:95"
K2_SOURCE = "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu"
K2_REPLACES = "src/repro/kernels/flash_attention/kernel.py:83"
K3_SOURCE = "src/repro_torch/kernels/flash_decode/csrc/flash_decode.cu"
K3_REPLACES = "src/repro/kernels/flash_decode/kernel.py:74"
K4_SOURCE = "src/repro_torch/kernels/ssd/csrc/ssd.cu"
K4_REPLACES = "src/repro/kernels/ssd/kernel.py:61"
# K2 and K3 against their plain versions: elementwise, and relative L2
# over the whole output.  Elementwise, float32: the reference's kernel
# tests; bf16: the same float32 arithmetic and one rounding of the output
# to bf16 in each version, at most 2**-7 relative apart, doubled.  The
# relative L2 bound is what catches a wrong tile or split (a dropped one
# of the 8 working splits of a 4096-position cache reads about 0.35); it
# stood 13x (bf16) and 40x (float32) above the largest error measured on
# an H100 over all shapes here before K2's tensor-core redesign (PERF.md).
ATTN_TOL = {torch.float32: dict(atol=2e-5, rtol=1e-4, rel_l2=1e-5),
            torch.bfloat16: dict(atol=1e-3, rtol=1.6e-2, rel_l2=1e-3)}
# Full-width logits, kernel path against the plain paths.  bf16 against
# "reference", which rounds scores and probabilities to bf16 where the
# kernels keep them float32: 1.2-1.6 % relative L2 at 2-6 layers of this
# model on the CPU.  float32 against "chunked", the kernels' float32
# attention math in another summation order.  (A bf16 gate against
# "chunked" at 1e-2 did not hold: one-ulp bf16 differences grow over 28
# layers to 1.7e-2, PERF.md; that distance is printed, not gated.)
LM_TOL = {"bfloat16": dict(rel_l2=5e-2, max_abs=0.25),
          "float32": dict(rel_l2=1e-3, max_abs=1e-2)}
# K4 against its plain version: float32 elementwise as the on-card K4
# test (tests/test_torch_ssd_kernel.py: the same float32 arithmetic in
# another order, the prefix sum of dt in token order where ssd_scan
# multiplies by a triangle of ones, and an error in that sum multiplied
# by |A| in an exponent); bf16 as ATTN_TOL (one rounding of y in each).
# A dropped 64 x 64 tile of a 256-token chunk moves y by O(1).
SSD_TOL = {torch.float32: dict(atol=1e-4, rtol=1e-3, rel_l2=1e-4),
           torch.bfloat16: dict(atol=1e-3, rtol=1.6e-2, rel_l2=1e-3)}
# K4 calls on the SSM models' own inputs.  There A reaches -16 and the
# prefix sums of dt reach ~200, so float32's own error of the function
# reaches 1.4e-3 x RMS(y) (ssd_scan against a float64 recurrence on
# mamba2-130m's first layer at 2048 tokens, on the CPU, by
# python -m repro_torch.serve.numerics), and
# the kernel and ssd_scan round that sum in different orders: their
# difference reached 6.8e-3 at RMS(y) ~2.3 on the card.  So the
# absolute floor is 4e-3 x RMS(y); a wrong element (an error of order
# RMS(y)) still fails by ~250x, and the relative L2 bound is unchanged.
SSD_CALL_TOL = {dt: dict(tol, atol_rms=4e-3) for dt, tol in SSD_TOL.items()}
# Whole-model float32 logits of the SSM paths against "chunked".
# Random-weight Mamba2 stacks at full width amplify rounding about 1.6x
# per layer: on the CPU (python -m repro_torch.serve.numerics), two
# correct float32 algorithms (the per-token recurrence and the chunked
# scan) end 0.09-2.6 % apart (relative L2) at mamba2-130m's 24 layers,
# and decode 2.8 % from prefill.  So every
# kernel call of these paths is gated against its plain version on its
# own inputs (SSD_TOL, ATTN_TOL), and the logits only catch a gross
# fault (a wrong kernel at one layer moves them by O(1)); the bf16
# distances, where one-ulp differences grow to O(1), are printed.
SSM_LM_TOL = dict(rel_l2=0.1, max_abs=1.0)
#: (arch, layers): mamba2-130m at full depth, zamba2-2.7b cut to two
#: of its shared-attention groups.
SSM_PATHS = (("mamba2-130m", 24), ("zamba2-2.7b", 12))
#: The earlier scalar K2 and chunk-split K3 alone at each path's shape
#: (PERF.md's kernel table: NVIDIA H100 80GB HBM3 at 700 W, timed with
#: the host's launch inside), printed beside the new times and nowhere
#: else.
EARLIER_MS = {("K2", "qwen3-0.6b"): 3.3810, ("K2", "zamba2-2.7b"): 4.6541,
              ("K3", "qwen3-0.6b"): 0.1146, ("K3", "zamba2-2.7b"): 0.1554}
LM_ARCH = "qwen3-0.6b"
PREFILL_B, PREFILL_S = 4, 2048
DECODE_B, DECODE_PROMPT, DECODE_STEPS, MAX_SEQ = 4, 16, 16, 4096
#: Phase 4b.  The split programs timed on the fused-source emitter
#: against K1, with their sizes (normalization's main-path size).
EMITTER_PATH = (("normalization", {"j": 4096, "i": 2048}),
                ("smooth_norm", {"j": 4096, "i": 2048}))
EMITTER_RUNS = 5
#: Sizes at which the reference's ``dim_sizes`` consult would route away
#: from the stencil kernel, timed on K1 and on the emitter: a block's
#: region over shared memory (K1 keeps it in global scratch), and rows
#: under the lane-occupancy floor.
CONSULT_PATH = (("laplace5", {"j": 256, "i": 16384}),
                ("hydro1d", {"j": 256, "i": 16384}),
                ("laplace5", {"j": 4096, "i": 24}))
#: Programs run through LayoutApply on the plain interpreter.
LAYOUT_PROGRAMS = ("cosmo", "hydro1d", "laplace5", "row_sum")
#: compile_batched's batch and programs (main-path sizes).
BATCH = 4
BATCHED_PATH = (("hydro1d", {"j": 2048, "i": 4096}),
                ("cosmo", {"k": 64, "j": 512, "i": 512}))
#: PlanServe's request stream: 48 requests in turn over the programs,
#: 2-D sizes drawn from SERVE_2D per dimension, cosmo SERVE_PLANES planes
#: of SERVE_COSMO x SERVE_COSMO, from a seeded generator.
SERVE_PROGRAMS = ("laplace5", "hydro1d", "normalization", "cosmo")
SERVE_REQUESTS, SERVE_MAX_BATCH = 48, 8
SERVE_2D, SERVE_COSMO, SERVE_PLANES = (1000, 2048), (480, 512), 16
#: Requests each pool of spawned workers answers.
WORKER_REQUESTS = 4


def close(got, want, tag: str, atol: float, rtol: float) -> float:
    """Max |got - want| (as float32); raises past the tolerance or on a
    non-finite value."""
    got, want = got.float(), want.float()
    if got.shape != want.shape:
        raise AssertionError(f"{tag}: shape {tuple(got.shape)} != "
                             f"{tuple(want.shape)}")
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{tag}: non-finite values")
    diff = (got - want).abs()
    n_bad = int((diff > atol + rtol * want.abs()).sum())
    if n_bad:
        raise AssertionError(f"{tag}: {n_bad} of {got.numel()} values past "
                             f"atol={atol} rtol={rtol} (max abs err "
                             f"{float(diff.max()):.3e})")
    return float(diff.max())


def gated(got, want, tag: str, tol: dict) -> tuple[float, float]:
    """(max abs err, relative L2 err) of a kernel's output against its
    plain version; raises past ``tol`` (atol, rtol, rel_l2, and
    optionally atol_rms: an absolute floor of atol_rms x RMS(want))."""
    from repro_torch.serve import bench as sb

    atol = tol["atol"]
    if "atol_rms" in tol:
        atol = max(atol, tol["atol_rms"]
                   * float(want.float().pow(2).mean().sqrt()))
    e = close(got, want, tag, atol, tol["rtol"])
    r = sb.rel_l2(got, want)
    if not r <= tol["rel_l2"]:
        raise AssertionError(f"{tag}: relative L2 err {r:.3e} past "
                             f"{tol['rel_l2']}")
    return e, r


def attn_close(got, want, tag: str) -> tuple[float, float]:
    """``gated`` at ``ATTN_TOL`` of the output's dtype."""
    return gated(got, want, tag, ATTN_TOL[want.dtype])


def ssd_close(got, want, tag: str, tols: dict = SSD_TOL) -> tuple[float,
                                                                   float]:
    """``gated`` at ``tols`` (``SSD_TOL``) of the output's dtype."""
    return gated(got, want, tag, tols[want.dtype])


def max_err(got: dict, want: dict, tag: str) -> float:
    """Max |got - want| over the goals; raises past the tolerance or on
    a non-finite value."""
    return max(close(got[k], w, f"{tag}:{k}", ATOL, RTOL)
               for k, w in want.items())


def drive(n: str, dims: dict, dev, flush, rate: float, smi: str) -> dict:
    """Run ``n`` once through ``compile_program`` (backend ``"cuda"``) at
    ``dims`` with the launch count set to 0 just before, hold it against
    the unfused evaluator and the plain interpreter, time it, and return
    its entry of the ``kernels`` line."""
    from repro_torch.core import ALL_PROGRAMS, build_unfused, compile_program
    from repro_torch.kernels import build
    from repro_torch.kernels.stencil2d import bench
    from repro_torch.kernels.stencil2d import kernel as k1

    prog = ALL_PROGRAMS[n]()
    gen = compile_program(prog, backend="cuda")
    arrs = bench.make_inputs(n, gen.kernel_plan, dims, 11, dev)
    k1.launches = 0
    got, records = bench.capture(lambda: gen.fn(**arrs))
    launches = k1.launches
    if launches == 0:
        raise AssertionError(f"main path {n}: no kernel launch")
    # the same launch again gives the same bits: the device fold of the
    # accumulators' partial rows runs in a fixed order
    again = gen.fn(**arrs)
    for k, v in got.items():
        if not torch.equal(v, again[k]):
            raise AssertionError(f"main/{n}:{k}: differs between two runs")

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
    # per call ("+" between calls): blocks, plane chunks x row chunks of
    # planes x rows each, shared memory, registers and local bytes a
    # thread of the built kernel, blocks an SM holds of it at this launch
    # (its occupancy query), waves of the grid, barriers a row step
    blocks = "+".join(str(run.nblocks) for _, _, run, _ in records)
    tiles = "+".join(f"{run.npchunks}x{run.nchunks} of "
                     f"{run.pchunk_len}x{run.chunk_len}"
                     for _, _, run, _ in records)
    smem = "+".join(str(run.smem_bytes) for _, _, run, _ in records)
    used = [build.registers(k1.job(lay.call)) for _, lay, _, _ in records]
    regs = "+".join(str(r) for r, _ in used)
    spill = "+".join(str(b) for _, b in used)
    resident = "+".join(str(run.resident) for _, _, run, _ in records)
    waves = "+".join(str(run.waves) for _, _, run, _ in records)
    barriers = "+".join(str(lay.barriers_per_row)
                        for _, lay, _, _ in records)
    shape = tuple(dims.values())
    print(f"main {n:14s} {shape}: launches={launches}  blocks={blocks} "
          f"({tiles})  smem={smem}  regs={regs}  local_bytes={spill}  "
          f"resident={resident}  waves={waves}  "
          f"barriers_per_row={barriers}  "
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
        "tiles": tiles, "regs": regs, "resident": resident, "waves": waves,
        "barriers_per_row": barriers,
    }


def main_dims(n: str, kplan) -> dict:
    """Loop-dim sizes of program ``n`` at main-path size: its own from
    the stencil main paths (the largest), else by its rank normalization's,
    cosmo's or advect4d_halo's."""
    from repro_torch.kernels.stencil2d import bench

    own = dict(bench.MAIN_PATH + bench.PLANE_WINDOW_PATH)
    if n in own:
        return own[n]
    by_rank = {2: {"j": 4096, "i": 2048}, 3: {"k": 64, "j": 512, "i": 512},
               4: {"l": 4, "k": 16, "j": 512, "i": 512}}
    return by_rank[len(kplan.loop_order)]


def timed_against_plain(n: str, run, plain, arrays: list, flush,
                        rate: float, tag: str, trim=lambda out: out) -> dict:
    """Call ``run`` (through K1) on each input of ``arrays`` recording its
    K1 calls, and the plain version ``plain`` on the same inputs, held
    against each other after ``trim`` (PlanServe's unpad to the request);
    returns the max error, the K1 calls' device time, the plain version's
    host-clocked time and the calls' byte bound."""
    from repro_torch.kernels.stencil2d import bench

    err = plain_ms = 0.0
    records = []
    for arrs in arrays:
        got, recs = bench.capture(lambda: run(arrs))
        records += recs
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = plain(arrs)
        torch.cuda.synchronize()
        plain_ms += (time.perf_counter() - t0) * 1e3
        err = max(err, max_err(trim(got), trim(want),
                               f"{tag}/{n}/interp_torch"))
    ms = sum(bench.kernel_ms(r, flush) for r in records)
    nbytes = sum(bench.call_bytes(lay, run, args)
                 for _, lay, run, args in records)
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": nbytes / rate * 1e3}


def serve_requests(dev) -> list:
    """PlanServe's seeded request stream: ``(program, {array: tensor})``,
    the programs in turn."""
    from repro_torch.core import ALL_PROGRAMS
    from repro_torch.kernels.stencil2d import bench

    gen = torch.Generator().manual_seed(5)

    def draw(lo_hi):
        return int(torch.randint(lo_hi[0], lo_hi[1] + 1, (1,),
                                 generator=gen))

    reqs = []
    for r in range(SERVE_REQUESTS):
        n = SERVE_PROGRAMS[r % len(SERVE_PROGRAMS)]
        kplan = compile_program_plain(ALL_PROGRAMS[n]())
        if n == "cosmo":
            dims = {"k": SERVE_PLANES, "j": draw(SERVE_COSMO),
                    "i": draw(SERVE_COSMO)}
        else:
            dims = {"j": draw(SERVE_2D), "i": draw(SERVE_2D)}
        reqs.append((n, bench.make_inputs(n, kplan, dims, 100 + r, dev)))
    return reqs


def compile_program_plain(prog):
    """``prog``'s kernel plan (the plain interpreter's compile on the CPU:
    nothing runs)."""
    from repro_torch.core import compile_program

    return compile_program(prog, backend="interp_torch",
                           device="cpu").kernel_plan


def compiler_phase(dev, flush, rate: float, smi: str) -> list:
    """Phase 4b: the compiler's entry points and PlanServe on the card —
    ``"auto"``'s routes, the fused-source emitter, LayoutApply on the
    plain interpreter, the on-disk plan cache, ``compile_batched`` and
    PlanServe (in process and in spawned workers), each through K1.
    Returns the K1 entries of the ``kernels`` line for the
    ``compile_batched`` and PlanServe paths."""
    import shutil
    import tempfile

    import repro_torch.core.engine as engine
    from repro_torch.core import (ALL_PROGRAMS, Generated, apply_layout,
                                  clear_compile_cache, compile_batched,
                                  compile_program)
    from repro_torch.core.engine import smem_report
    from repro_torch.core.vecscan import auto_vec_reject
    from repro_torch.kernels import build
    from repro_torch.kernels.stencil2d import bench
    from repro_torch.kernels.stencil2d import kernel as k1
    from repro_torch.kernels.stencil2d.emit import SMEM_LIMIT
    from repro_torch.serve.plans import (PlanServe, bucket_sizes,
                                         pad_to_bucket, request_sizes,
                                         unpad_outputs)
    from repro_torch.serve.workers import WorkerPool

    t_phase = time.perf_counter()
    entries = []
    plans = {n: compile_program_plain(b())
             for n, b in sorted(ALL_PROGRAMS.items())}

    # 1. "auto"'s routes on the card, without and with dim_sizes at
    # main-path size: every program takes K1 and launches it
    for n, b in sorted(ALL_PROGRAMS.items()):
        dims = main_dims(n, plans[n])
        sizes = {sym: dims[d] for d, sym in plans[n].dim_sizes}
        routes = []
        for gen in (compile_program(b()), compile_program(b(),
                                                          dim_sizes=sizes)):
            route = "torch" if isinstance(gen, Generated) else gen.interpreter
            if route != "cuda":
                raise AssertionError(f"auto/{n}: took {route!r}, not 'cuda'")
            routes.append(route)
        arrs = bench.make_inputs(n, plans[n], CONFORMANCE_DIMS, 7, dev)
        k1.launches = 0
        gen.fn(**arrs)
        torch.cuda.synchronize()
        if k1.launches == 0:
            raise AssertionError(f"auto/{n}: no K1 launch")
        smem = "+".join(str(v) for v in smem_report(plans[n],
                                                    sizes).values())
        nests = len(engine._build_plan(b())[1].schedule.nests)
        print(f"auto {n:22s} nests={nests} route={routes[0]}  with "
              f"dim_sizes {sizes}: route={routes[1]}  K1 launches="
              f"{k1.launches}  K1 region a block={smem} B (shared memory "
              f"holds {SMEM_LIMIT})", flush=True)

    # 2. the fused-source emitter: all 15 programs against interp_torch
    # on the card, then the split programs timed against K1
    for n, b in sorted(ALL_PROGRAMS.items()):
        arrs = bench.make_inputs(n, plans[n], CONFORMANCE_DIMS, 7, dev)
        got = compile_program(b(), backend="torch").fn(**arrs)
        want = compile_program(b(), backend="interp_torch",
                               device=dev).fn(**arrs)
        print(f"emitter {n:22s} max_abs_err vs interp_torch: "
              f"{max_err(got, want, f'emitter/{n}'):.3e}", flush=True)
    for n, dims in EMITTER_PATH:
        prog = ALL_PROGRAMS[n]()
        arrs = bench.make_inputs(n, plans[n], dims, 11, dev)
        emitted = compile_program(prog, backend="torch")
        kernel = compile_program(prog, backend="cuda")
        err = max_err(emitted.fn(**arrs), kernel.fn(**arrs),
                      f"emitter/{n}/cuda")
        em_ms = bench.event_ms(lambda: emitted.fn(**arrs), flush,
                               runs=EMITTER_RUNS)
        k1_ms = bench.event_ms(lambda: kernel.fn(**arrs), flush,
                               runs=EMITTER_RUNS)
        print(f"emitter {n} {tuple(dims.values())}: torch_fn_ms={em_ms:.3f}"
              f"  cuda_fn_ms={k1_ms:.4f}  ratio={em_ms / k1_ms:.0f}x  "
              f"max_abs_err vs cuda={err:.3e}  card: {smi}", flush=True)
    # where the reference's consult would route away: K1 (from global
    # scratch where the region outgrows shared memory) against the
    # emitter, held against each other
    for n, dims in CONSULT_PATH:
        prog = ALL_PROGRAMS[n]()
        sizes = {sym: dims[d] for d, sym in plans[n].dim_sizes}
        why = [f"region {v} B" for v in smem_report(plans[n],
                                                    sizes).values()
               if v > SMEM_LIMIT]
        vec = auto_vec_reject(plans[n], sizes)
        if vec:
            why.append(vec)
        if not why:
            raise AssertionError(f"consult/{n}: {sizes} is not a size the "
                                 f"consult would route away")
        arrs = bench.make_inputs(n, plans[n], dims, 11, dev)
        emitted = compile_program(prog, backend="torch")
        kernel = compile_program(prog)
        if kernel.interpreter != "cuda":
            raise AssertionError(f"consult/{n}: auto took "
                                 f"{kernel.interpreter!r}")
        got, records = bench.capture(lambda: kernel.fn(**arrs))
        err = max_err(emitted.fn(**arrs), got, f"consult/{n}/cuda")
        scratch = "+".join("global scratch" if run.smem_bytes == 0
                           else f"shared {run.smem_bytes} B"
                           for _, _, run, _ in records)
        em_ms = bench.event_ms(lambda: emitted.fn(**arrs), flush,
                               runs=EMITTER_RUNS)
        k1_ms = bench.event_ms(lambda: kernel.fn(**arrs), flush,
                               runs=EMITTER_RUNS)
        print(f"consult {n} {tuple(dims.values())} ({'; '.join(why)}): "
              f"K1 in {scratch}  cuda_fn_ms={k1_ms:.4f}  "
              f"torch_fn_ms={em_ms:.3f}  ratio={em_ms / k1_ms:.0f}x  "
              f"max_abs_err vs torch={err:.3e}  card: {smi}", flush=True)

    # 3. LayoutApply on the plain interpreter, on the card
    for n in LAYOUT_PROGRAMS:
        arrs = bench.make_inputs(n, plans[n], CONFORMANCE_DIMS, 7, dev)
        base = compile_program(ALL_PROGRAMS[n](), backend="interp_torch",
                               device=dev).fn(**arrs)
        for mode in ("auto", "force"):
            gen = compile_program(ALL_PROGRAMS[n](), backend="interp_torch",
                                  device=dev, apply_layout=mode)
            got = gen.fn(**arrs)
            # what the pass did (an executor whose plan the pass left
            # unchanged is shared with the untransformed compile's)
            res = apply_layout(plans[n], mode=mode)
            exact = all(k in ("shift_reuse", "realign_origin")
                        for k, _, _ in res.applied)
            if exact:
                for k in base:
                    if not torch.equal(got[k], base[k]):
                        raise AssertionError(f"layout/{n}/{mode}:{k}: a "
                                             f"bit-exact rewrite changed bits")
            err = max_err(got, base, f"layout/{n}/{mode}")
            print(f"layout {n:10s} {mode:5s} applied="
                  f"{[f'{k}:{t}' for k, _, t in res.applied]} skipped="
                  f"{[f'{k}:{t} ({why})' for k, _, t, why in res.skipped]} "
                  f"{'bit-identical' if exact else 'within tolerance'} "
                  f"(max_abs_err {err:.3e})", flush=True)

    # 4. the on-disk plan cache: cold compile, in-memory caches cleared,
    # warm compile with the analysis pipeline counted
    cache_dir = tempfile.mkdtemp(prefix="plancache-", dir=build.BUILD_DIR)
    try:
        for n, dims in bench.MAIN_PATH:
            clear_compile_cache()
            t0 = time.perf_counter()
            cold = compile_program(ALL_PROGRAMS[n](), backend="cuda",
                                   plan_cache_dir=cache_dir)
            cold_ms = (time.perf_counter() - t0) * 1e3
            clear_compile_cache()
            ran = []
            real_infer = engine.infer

            def counted(*a, **k):
                ran.append(1)
                return real_infer(*a, **k)

            engine.infer = counted
            try:
                t0 = time.perf_counter()
                warm = compile_program(ALL_PROGRAMS[n](), backend="cuda",
                                       plan_cache_dir=cache_dir)
                warm_ms = (time.perf_counter() - t0) * 1e3
            finally:
                engine.infer = real_infer
            if ran or warm.plan is not None:
                raise AssertionError(f"plancache/{n}: the warm compile ran "
                                     f"the analysis pipeline")
            arrs = bench.make_inputs(n, plans[n], dims, 11, dev)
            a, b = cold.fn(**arrs), warm.fn(**arrs)
            for k in a:
                if not torch.equal(a[k], b[k]):
                    raise AssertionError(f"plancache/{n}:{k}: warm differs")
            print(f"plancache {n:14s} cold_compile_ms={cold_ms:.1f}  "
                  f"warm_compile_ms={warm_ms:.1f}  infer calls warm=0  "
                  f"bit-identical", flush=True)
    finally:
        shutil.rmtree(cache_dir, ignore_errors=True)

    # 5. compile_batched on K1, B = 4, against four single calls
    for n, dims in BATCHED_PATH:
        prog = ALL_PROGRAMS[n]()
        examples = [bench.make_inputs(n, plans[n], dims, 20 + b, dev)
                    for b in range(BATCH)]
        batch = {k: torch.stack([e[k] for e in examples])
                 for k in examples[0]}
        bgen = compile_batched(prog, "cuda")
        single = compile_program(prog, backend="cuda")
        k1.launches = 0
        out = bgen.fn(batch)
        torch.cuda.synchronize()
        launches = k1.launches
        if launches == 0:
            raise AssertionError(f"batched/{n}: no K1 launch")
        for b, ex in enumerate(examples):
            want = single.fn(**ex)
            for k in want:
                if not torch.equal(out[k][b], want[k]):
                    raise AssertionError(f"batched/{n}:{k}[{b}]: differs "
                                         f"from a single call")
        batched_ms = bench.event_ms(lambda: bgen.fn(batch), flush,
                                    runs=EMITTER_RUNS)
        singles_ms = bench.event_ms(
            lambda: [single.fn(**ex) for ex in examples], flush,
            runs=EMITTER_RUNS)
        shape = "x".join(map(str, (BATCH, *dims.values())))
        line = (f"batched {n} {shape}: launches={launches}  bit-identical "
                f"to {BATCH} single calls  batched_fn_ms={batched_ms:.4f}  "
                f"singles_fn_ms={singles_ms:.4f}")
        if n == BATCHED_PATH[0][0]:
            # the kernels line's entry: every call held against the
            # plain version on the same batch
            plain = compile_batched(prog, "interp_torch", device=dev)
            stats = timed_against_plain(n, bgen.fn, plain.fn, [batch],
                                        flush, rate, "batched")
            line += (f"  kernel_ms={stats['ms']:.4f}  plain_ms="
                     f"{stats['plain_ms']:.1f}  bound_ms="
                     f"{stats['bound_ms']:.4f}  err_vs_plain="
                     f"{stats['max_abs_err']:.3e}")
            entries.append({
                "name": f"stencil2d[compile_batched {n} {shape}]",
                "route": "cuda", "source": K1_SOURCE,
                "replaces": K1_REPLACES, "launches": launches,
                **stats, "bound_by": "bytes", "library_ms": None,
                "fn_ms": batched_ms, "singles_fn_ms": singles_ms})
        print(line + f"  card: {smi}", flush=True)

    # 6. PlanServe on K1: 48 requests of mixed sizes, each answer equal
    # to a per-example K1 compile at its true size
    progs = {n: ALL_PROGRAMS[n]() for n in SERVE_PROGRAMS}
    reqs = serve_requests(dev)
    clear_compile_cache()
    k1.launches = 0
    with PlanServe(progs, max_batch=SERVE_MAX_BATCH) as srv:
        if srv.backend != "cuda":
            raise AssertionError(f"PlanServe's default backend on the card "
                                 f"is {srv.backend!r}")
        tickets = [(n, a, srv.submit(n, a)) for n, a in reqs]
        answers = [(n, a, t.result(600)) for n, a, t in tickets]
        snap = srv.metrics.snapshot()
    launches = k1.launches
    if launches == 0:
        raise AssertionError("planserve: no K1 launch")
    for n, a, out in answers:
        want = compile_program(progs[n], backend="cuda").fn(**a)
        for k in want:
            if not torch.equal(out[k], want[k]):
                raise AssertionError(f"planserve/{n}:{k}: differs from a "
                                     f"per-example K1 call at "
                                     f"{tuple(want[k].shape)}")
    print(f"planserve {len(answers)} requests over {SERVE_PROGRAMS}: every "
          f"answer bit-identical to a per-example K1 call at its true size; "
          f"K1 launches={launches}", flush=True)
    print(f"planserve metrics: requests={snap['requests']} batches="
          f"{snap['batches']} requests_per_s={snap['requests_per_s']:.2f} "
          f"latency_ms p50={snap['latency_ms']['p50']:.2f} "
          f"p99={snap['latency_ms']['p99']:.2f} queue_wait_ms "
          f"p50={snap['queue_wait_ms']['p50']:.2f} batch_size mean="
          f"{snap['batch_size']['mean']:.2f} max={snap['batch_size']['max']} "
          f"compiles={snap['compiles']['count']} "
          f"(disk hits {snap['compiles']['disk_hits']}, "
          f"{snap['compiles']['total_ms']:.0f} ms) buckets="
          f"{len(snap['buckets'])}  card: {smi}", flush=True)
    # the kernels line's entry: the first request of each program, as
    # the server ran it (padded to its bucket), through K1 and the plain
    # version
    firsts = {}
    for n, a, _ in answers:
        firsts.setdefault(n, a)
    stats = {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0}
    for n, a in firsts.items():
        prog = progs[n]
        bucket = bucket_sizes(prog, request_sizes(prog, a),
                              srv._quantum[n])  # as the server bucketed it
        padded = pad_to_bucket(prog, a, bucket, device=dev)
        gen = compile_program(prog, backend="cuda")
        plain = compile_program(prog, backend="interp_torch", device=dev)
        sizes = request_sizes(prog, a)
        s = timed_against_plain(
            n, lambda x: gen.fn(**x), lambda x: plain.fn(**x), [padded],
            flush, rate, "planserve",
            trim=lambda out: unpad_outputs(prog, out, sizes))
        stats["max_abs_err"] = max(stats["max_abs_err"], s["max_abs_err"])
        for key in ("ms", "plain_ms", "bound_ms"):
            stats[key] += s[key]
    entries.append({
        "name": f"stencil2d[PlanServe {SERVE_REQUESTS} requests: "
                f"{', '.join(SERVE_PROGRAMS)}]",
        "route": "cuda", "source": K1_SOURCE, "replaces": K1_REPLACES,
        "launches": launches, **stats, "bound_by": "bytes",
        "library_ms": None,
        "timed": "the first request of each program, padded to its bucket",
        "requests_per_s": snap["requests_per_s"],
        "latency_ms_p50": snap["latency_ms"]["p50"],
        "latency_ms_p99": snap["latency_ms"]["p99"]})

    # 7. spawned workers on the card over one plan-cache directory: a
    # cold pool, then a warm one
    cache_dir = tempfile.mkdtemp(prefix="plancache-", dir=build.BUILD_DIR)
    try:
        for label in ("cold", "warm"):
            t0 = time.perf_counter()
            with WorkerPool(2, SERVE_PROGRAMS, cache_dir=cache_dir,
                            max_batch=SERVE_MAX_BATCH) as pool:
                start_s = time.perf_counter() - t0
                t1 = time.perf_counter()
                for n, a in reqs[:WORKER_REQUESTS]:
                    out = pool.serve(n, {k: v.cpu().numpy()
                                         for k, v in a.items()})
                    want = compile_program(progs[n], backend="cuda").fn(**a)
                    for k in want:
                        if not torch.equal(torch.from_numpy(out[k]),
                                           want[k].cpu()):
                            raise AssertionError(f"workers/{label}/{n}:{k}: "
                                                 f"differs from K1")
                serve_s = time.perf_counter() - t1
                snaps = pool.close()
            hits = sum(s["compiles"]["disk_hits"] for s in snaps)
            compiles = sum(s["compiles"]["count"] for s in snaps)
            print(f"workers {label}: 2 spawned workers started in "
                  f"{start_s:.1f} s; {WORKER_REQUESTS} requests answered in "
                  f"{serve_s:.1f} s, each bit-identical to K1; compiles="
                  f"{compiles} (disk hits {hits})  card: {smi}", flush=True)
            if label == "warm" and hits != compiles:
                raise AssertionError("workers/warm: a compile missed the "
                                     "shared plan cache")
    finally:
        shutil.rmtree(cache_dir, ignore_errors=True)
    print(f"compiler entry points and PlanServe: "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    return entries


def attention_conformance(dev) -> dict:
    """K2 and K3 against their plain versions on the card over the case
    grid; returns the max (abs, relative L2) errors per kernel and
    dtype."""
    from repro_torch.kernels.flash_attention import kernel as k2
    from repro_torch.kernels.flash_decode import kernel as k3

    gen = torch.Generator(device=dev).manual_seed(5)
    errs: dict = {}

    def rnd(*shape, dtype):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    # K2: ragged S, and Sq < Skv at the default q_offset
    for dt, D, group, causal, window, (Sq, Skv, q_off) in itertools.product(
            (torch.float32, torch.bfloat16), (64, 80, 128), (1, 2, 4),
            (True, False), (None, 100), ((257, 257, 0), (190, 333, None))):
        q = rnd(2, Sq, 2 * group, D, dtype=dt)
        k = rnd(2, Skv, 2, D, dtype=dt)
        v = rnd(2, Skv, 2, D, dtype=dt)
        got = k2.flash_attention_fwd(q, k, v, causal=causal, window=window,
                                     q_offset=q_off)
        torch.cuda.synchronize()
        want = k2.flash_attention_plain(
            q, k, v, causal=causal, window=window,
            q_offset=Skv - Sq if q_off is None else q_off, scale=D ** -0.5)
        e = attn_close(got, want, f"K2 {dt} D={D} g={group} causal={causal} "
                       f"window={window} Sq={Sq} Skv={Skv}")
        key = ("flash_attention", str(dt))
        errs[key] = tuple(map(max, errs.get(key, (0.0, 0.0)), e))
    # K3: ragged and windowed lengths over a 1000-position cache
    for (qdt, cdt), D, group, window in itertools.product(
            ((torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
             (torch.bfloat16, torch.float32)), (64, 80, 128), (1, 2, 4),
            (None, 300)):
        q = rnd(3, 2 * group, D, dtype=qdt)
        kc = rnd(3, 1000, 2, D, dtype=cdt)
        vc = rnd(3, 1000, 2, D, dtype=cdt)
        lengths = torch.tensor([1, 517, 1000], dtype=torch.int32, device=dev)
        got = k3.flash_decode(q, kc, vc, lengths, window=window)
        torch.cuda.synchronize()
        want = k3.flash_decode_plain(q, kc, vc, lengths, window=window,
                                     scale=D ** -0.5)
        e = attn_close(got, want, f"K3 {qdt}/{cdt} D={D} g={group} "
                       f"window={window}")
        key = ("flash_decode", f"{qdt}/{cdt}")
        errs[key] = tuple(map(max, errs.get(key, (0.0, 0.0)), e))
    return errs


def lm_check(got, want, tag: str, rel_l2: float, max_abs: float) -> dict:
    """Logits of the kernel path against a plain path; raises past the
    stated tolerance or on a non-finite value."""
    from repro_torch.serve import bench as sb

    if got.shape != want.shape or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{tag}: shape {tuple(got.shape)} vs "
                             f"{tuple(want.shape)}, or non-finite logits")
    r = sb.rel_l2(got, want)
    m = float((got - want).abs().max())
    if r > rel_l2 or m > max_abs:
        raise AssertionError(f"{tag}: rel L2 {r:.3e} (limit {rel_l2}), max "
                             f"abs err {m:.3e} (limit {max_abs})")
    return {"rel_l2": r, "max_abs_err": m}


def serve_lm(dev, flush, rate: float, smi: str) -> list:
    """The LM main path at full width (prefill, then greedy decode), each
    driven once with the launch counts set to 0 just before it, checked
    against the plain paths and timed; then K2 and K3 alone.  Returns
    their entries of the ``kernels`` line."""
    from repro_torch.configs import ARCHS
    from repro_torch.kernels.flash_attention import kernel as k2
    from repro_torch.kernels.flash_decode import kernel as k3
    from repro_torch.kernels.stencil2d import bench
    from repro_torch.models import decode_step, init_caches, init_params
    from repro_torch.models.lm import cast
    from repro_torch.serve import bench as sb
    from repro_torch.serve import greedy_decode, make_prefill_step

    cfg = ARCHS[LM_ARCH].replace(attn_impl="pallas")
    dt = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(0)
    t0 = time.perf_counter()
    masters = init_params(gen, cfg, device=dev)
    params = cast(masters, dt)
    torch.cuda.synchronize()
    print(f"lm: {cfg.name} {cfg.n_layers} layers d_model={cfg.d_model} "
          f"heads={cfg.n_heads}/{cfg.n_kv_heads} head_dim={cfg.hd} "
          f"vocab={cfg.vocab}, bf16 weights from seed 0 in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    # prefill: B=4 prompts of S=2048
    tokens = torch.randint(0, cfg.vocab, (PREFILL_B, PREFILL_S),
                           generator=gen, device=dev)
    prefill = make_prefill_step(cfg, device=dev)
    k2.launches = k3.launches = 0
    logits, caches = prefill(params, {"tokens": tokens})
    torch.cuda.synchronize()
    k2_launches, k3_prefill = k2.launches, k3.launches
    if k2_launches != cfg.n_layers:
        raise AssertionError(f"prefill: {k2_launches} K2 launches, expected "
                             f"{cfg.n_layers}")
    del caches
    want, _ = make_prefill_step(cfg.replace(attn_impl="reference"),
                                device=dev)(params, {"tokens": tokens})
    check = lm_check(logits, want, "prefill vs reference",
                     **LM_TOL["bfloat16"])
    chunked, _ = make_prefill_step(cfg.replace(attn_impl="chunked"),
                                   device=dev)(params, {"tokens": tokens})
    spread = {"kernel_vs_chunked": sb.rel_l2(logits, chunked),
              "chunked_vs_reference": sb.rel_l2(chunked, want)}
    # the same weights in float32: the kernel path against "chunked"
    f32 = cfg.replace(dtype="float32")
    got32, _ = make_prefill_step(f32, device=dev)(masters,
                                                  {"tokens": tokens})
    want32, _ = make_prefill_step(f32.replace(attn_impl="chunked"),
                                  device=dev)(masters, {"tokens": tokens})
    check32 = lm_check(got32, want32, "float32 prefill vs chunked",
                       **LM_TOL["float32"])
    del masters, want, chunked, got32, want32
    prefill_ms = bench.event_ms(lambda: prefill(params, {"tokens": tokens}),
                                flush, runs=5)
    print(f"prefill B={PREFILL_B} S={PREFILL_S}: K2 launches={k2_launches} "
          f"(K3 {k3_prefill})  logits {tuple(logits.shape)} vs reference "
          f"{check}  rel L2 {spread}  float32 vs chunked {check32}  "
          f"prefill_ms={prefill_ms:.3f}  "
          f"tokens/s={PREFILL_B * PREFILL_S / prefill_ms * 1e3:.0f}  "
          f"card: {smi}", flush=True)

    # greedy decode: B=4, 16-token prompts, 16 steps, bf16 caches of 4096
    prompt = torch.randint(0, cfg.vocab, (DECODE_B, DECODE_PROMPT),
                           generator=gen, device=dev)
    seen = []
    k2.launches = k3.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = greedy_decode(params, cfg, prompt, DECODE_STEPS, MAX_SEQ,
                        cache_dtype=dt, device=dev, on_logits=seen.append)
    torch.cuda.synchronize()
    greedy_ms = (time.perf_counter() - t0) * 1e3
    k3_launches, k2_decode = k3.launches, k2.launches
    n_steps = DECODE_PROMPT + DECODE_STEPS - 1
    if k3_launches != cfg.n_layers * n_steps:
        raise AssertionError(f"decode: {k3_launches} K3 launches, expected "
                             f"{cfg.n_layers * n_steps}")
    if out.shape != (DECODE_B, DECODE_STEPS) or \
            not bool(((out >= 0) & (out < cfg.vocab)).all()):
        raise AssertionError(f"decode: tokens {tuple(out.shape)} out of range")
    # the plain path fed the same tokens
    ref_cfg = cfg.replace(attn_impl="reference")
    feed = torch.cat([prompt, out[:, :-1]], dim=1)
    caches = init_caches(ref_cfg, DECODE_B, MAX_SEQ, cache_dtype=dt,
                         device=dev)
    lengths = torch.zeros((DECODE_B,), dtype=torch.int32, device=dev)
    worst = {"rel_l2": 0.0, "max_abs_err": 0.0}
    for t in range(n_steps):
        lengths = lengths + 1
        want = decode_step(params, feed[:, t], caches, lengths, ref_cfg)
        c = lm_check(seen[t], want, f"decode step {t} vs reference",
                     **LM_TOL["bfloat16"])
        worst = {k: max(worst[k], c[k]) for k in worst}
    # a steady decode step: the kernel path's caches at the prompt's end
    caches = init_caches(cfg, DECODE_B, MAX_SEQ, cache_dtype=dt, device=dev)
    lengths = torch.zeros((DECODE_B,), dtype=torch.int32, device=dev)
    for t in range(n_steps):
        lengths = lengths + 1
        decode_step(params, feed[:, t], caches, lengths, cfg)
    step_ms = bench.event_ms(
        lambda: decode_step(params, feed[:, -1], caches, lengths, cfg),
        flush, runs=20)
    q = torch.randn((DECODE_B, cfg.n_heads, cfg.hd), generator=gen,
                    device=dev).to(dt)
    _, k3_step = k3.prepare(q, caches["k"][0], caches["v"][0], lengths,
                            window=None, scale=cfg.hd ** -0.5)
    k3_step_ms = bench.device_ms(k3_step, flush, runs=20)
    step_split = k3_step()
    torch.cuda.synchronize()
    print(f"decode B={DECODE_B} prompt={DECODE_PROMPT} steps={DECODE_STEPS} "
          f"max_seq={MAX_SEQ} bf16 caches: K3 launches={k3_launches} "
          f"(K2 {k2_decode})  per-step logits vs reference {worst}  "
          f"greedy_ms={greedy_ms:.1f} ({n_steps} steps, "
          f"{greedy_ms / n_steps:.3f} ms/step incl. host)  "
          f"step_ms={step_ms:.3f} at length {int(lengths[0])}  "
          f"tokens/s={DECODE_B / step_ms * 1e3:.0f}  "
          f"K3 at that length {k3_step_ms:.4f} ms x {cfg.n_layers} layers = "
          f"{100 * k3_step_ms * cfg.n_layers / step_ms:.1f} % of a step "
          f"({step_split.split_blocks} split blocks, {step_split.working} "
          f"holding keys)  "
          f"card: {smi}", flush=True)
    # where the device time goes (torch.profiler): the kernels' device
    # time over the profiled wall time (a lower bound of the busy share,
    # the profiler adds host time to every operator) and over the same
    # work's CUDA-event time without the profiler
    for tag, fn, runs, plain_wall in (
            ("prefill", lambda: prefill(params, {"tokens": tokens}), 1,
             prefill_ms),
            ("decode step", lambda: decode_step(params, feed[:, -1], caches,
                                                lengths, cfg), 5, step_ms)):
        wall, dev_ms, top = sb.device_share(fn, runs)
        if dev_ms == 0:
            print(f"profile {tag}: wall_ms={wall:.3f}, the profiler saw no "
                  f"device time: busy share not measured", flush=True)
            continue
        print(f"profile {tag}: device_ms={dev_ms:.3f}  profiled wall_ms="
              f"{wall:.3f} (busy >= {100 * dev_ms / wall:.1f} %)  event "
              f"ms={plain_wall:.3f} (busy ~ {100 * dev_ms / plain_wall:.1f} "
              f"%)  top kernels (ms): "
              + "; ".join(f"{k} {t:.3f}" for k, t in top), flush=True)
    del caches

    # K2 alone at the prefill shape, K3 alone over a full 4096-position
    # bf16 cache
    H, KVH, D = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = torch.randn((PREFILL_B, PREFILL_S, H, D), generator=gen,
                    device=dev).to(dt)
    k = torch.randn((PREFILL_B, PREFILL_S, KVH, D), generator=gen,
                    device=dev).to(dt)
    v = torch.randn((PREFILL_B, PREFILL_S, KVH, D), generator=gen,
                    device=dev).to(dt)
    e2 = k2_alone(q, k, v, LM_ARCH, flush, rate, smi,
                  calls=cfg.n_layers, prefill_ms=prefill_ms)
    del q, k, v
    e3 = k3_alone(DECODE_B, H, KVH, D, dt, gen, LM_ARCH, flush, rate, smi)
    return [
        {"name": f"flash_attention[{LM_ARCH} prefill B={PREFILL_B} "
                 f"S={PREFILL_S} causal bf16]",
         "launches": k2_launches, **e2, "prefill_ms": prefill_ms},
        {"name": f"flash_decode[{LM_ARCH} B={DECODE_B} S={MAX_SEQ} "
                 f"bf16 cache]",
         "launches": k3_launches, **e3, "decode_step_ms": step_ms},
    ]


def k2_alone(q, k, v, tag: str, flush, rate: float, smi: str, *,
             calls: int, prefill_ms: float) -> dict:
    """K2 alone on (q, k, v), causal: its wrapper against the plain
    version, then its launch timed beside the plain version, one
    ``scaled_dot_product_attention`` call and its bound.  Returns the
    fields of its ``kernels`` entry but the name and launches."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import kernel as k2
    from repro_torch.kernels.stencil2d import bench
    from repro_torch.serve import bench as sb

    B, S, H, D = q.shape
    KVH = k.shape[2]
    run = dict(causal=True, window=None, q_offset=0, scale=D ** -0.5)
    want = k2.flash_attention_plain(q, k, v, **run)
    err, rel = attn_close(k2.flash_attention_fwd(q, k, v, **run), want,
                          f"K2 at the {tag} prefill shape")
    # time the launch alone, through the helper the wrapper launches by
    o, k2_run = k2.prepare(q, k, v, **run)
    blocks = k2_run()
    attn_close(o, want, f"K2 at the {tag} prefill shape, timed launch")
    ms = bench.device_ms(k2_run, flush)
    plain_ms = bench.device_ms(
        lambda: k2.flash_attention_plain(q, k, v, **run), flush, runs=5)
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    lib_ms = bench.device_ms(
        lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                               enable_gqa=True), flush)
    flops, nbytes = sb.attention_work(q, k, v, causal=True, window=None,
                                      q_offset=0)
    bound, by = sb.bound_ms(flops, nbytes,
                            sb.bf16_peak(torch.cuda.get_device_name(q.device)),
                            rate)
    print(f"K2 ({tag}: B={B} S={S} H={H} KVH={KVH} D={D} causal "
          f"{str(q.dtype).replace('torch.', '')}): ms={ms:.4f} (the earlier "
          f"kernel, with its launch: {EARLIER_MS['K2', tag]:.4f})  "
          f"plain_ms={plain_ms:.3f}  sdpa_ms={lib_ms:.4f}  "
          f"flops={flops:.3e} bytes={nbytes}  bound_ms={bound:.4f} ({by})  "
          f"{flops / ms / 1e9:.1f} TFLOP/s  "
          f"{100 * ms * calls / prefill_ms:.1f} % of prefill  "
          f"blocks={blocks}  max_abs_err={err:.3e}  "
          f"rel_l2_err={rel:.3e}  card: {smi}", flush=True)
    return {"route": "cuda", "source": K2_SOURCE, "replaces": K2_REPLACES,
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": by, "library_ms": lib_ms,
            "rel_l2_err": rel, "blocks": str(blocks)}


def k3_alone(B: int, H: int, KVH: int, D: int, dt, gen, tag: str, flush,
             rate: float, smi: str) -> dict:
    """K3 alone over a full ``MAX_SEQ``-position cache of random values
    from ``gen``: its wrapper against the plain version, then its launch
    timed beside the plain version, one SDPA call and its bound.
    Returns the fields of its ``kernels`` entry but the name and
    launches."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_decode import kernel as k3
    from repro_torch.kernels.stencil2d import bench
    from repro_torch.serve import bench as sb

    dev = gen.device
    q = torch.randn((B, H, D), generator=gen, device=dev).to(dt)
    kc = torch.randn((B, MAX_SEQ, KVH, D), generator=gen, device=dev).to(dt)
    vc = torch.randn((B, MAX_SEQ, KVH, D), generator=gen, device=dev).to(dt)
    lengths = torch.full((B,), MAX_SEQ, dtype=torch.int32, device=dev)
    want = k3.flash_decode_plain(q, kc, vc, lengths, window=None,
                                 scale=D ** -0.5)
    err, rel = attn_close(k3.flash_decode(q, kc, vc, lengths), want,
                          f"K3 at a full {tag} cache")
    o, k3_run = k3.prepare(q, kc, vc, lengths, window=None, scale=D ** -0.5)
    res = k3_run()
    torch.cuda.synchronize()
    blocks = f"{res.split_blocks}+{res.combine_blocks}"  # split + combine
    attn_close(o, want, f"K3 at a full {tag} cache, timed launch")
    ms = bench.device_ms(k3_run, flush)
    plain_ms = bench.device_ms(
        lambda: k3.flash_decode_plain(q, kc, vc, lengths, window=None,
                                      scale=D ** -0.5), flush)
    qt = q[:, :, None]
    kt, vt = (t.transpose(1, 2).contiguous() for t in (kc, vc))
    lib_ms = bench.device_ms(
        lambda: F.scaled_dot_product_attention(qt, kt, vt, enable_gqa=True),
        flush)
    del kt, vt
    flops, nbytes = sb.decode_work(q, kc, vc, lengths, window=None)
    peak = sb.bf16_peak(torch.cuda.get_device_name(dev))
    bound, by = sb.bound_ms(flops, nbytes, peak, rate)
    print(f"K3 ({tag}: B={B} H={H} KVH={KVH} D={D} S=lengths={MAX_SEQ} "
          f"{str(dt).replace('torch.', '')} cache, blocks={blocks} "
          f"split+combine, {res.working} split blocks holding keys): "
          f"ms={ms:.4f} (the earlier kernel, with its launch: "
          f"{EARLIER_MS['K3', tag]:.4f})  "
          f"plain_ms={plain_ms:.4f}  "
          f"sdpa_ms={lib_ms:.4f}  bytes={nbytes}  bound_ms={bound:.4f} "
          f"({by})  {nbytes / ms / 1e6:.1f} GB/s  max_abs_err={err:.3e}  "
          f"rel_l2_err={rel:.3e}  card: {smi}", flush=True)
    # the main path's shape: lengths 31 of the same cache
    short = torch.full((B,), DECODE_PROMPT + DECODE_STEPS - 1,
                       dtype=torch.int32, device=dev)
    want = k3.flash_decode_plain(q, kc, vc, short, window=None,
                                 scale=D ** -0.5)
    o, k3_short = k3.prepare(q, kc, vc, short, window=None, scale=D ** -0.5)
    res = k3_short()
    torch.cuda.synchronize()
    short_err = attn_close(o, want, f"K3 at {tag} lengths {int(short[0])} "
                           f"of {MAX_SEQ}, timed launch")
    short_ms = bench.device_ms(k3_short, flush)
    flops, nbytes = sb.decode_work(q, kc, vc, short, window=None)
    short_bound, short_by = sb.bound_ms(flops, nbytes, peak, rate)
    print(f"K3 ({tag} at the main path's lengths {int(short[0])} of "
          f"{MAX_SEQ}): ms={short_ms:.4f}  split blocks launched="
          f"{res.split_blocks} holding keys={res.working} (+"
          f"{res.combine_blocks} combine)  bytes={nbytes}  "
          f"bound_ms={short_bound:.6f} ({short_by})  "
          f"max_abs_err={short_err[0]:.3e}  rel_l2_err={short_err[1]:.3e}  "
          f"card: {smi}", flush=True)
    return {"route": "cuda", "source": K3_SOURCE, "replaces": K3_REPLACES,
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": by, "library_ms": lib_ms,
            "rel_l2_err": rel, "blocks": blocks,
            "short_ms": short_ms, "short_bound_ms": short_bound,
            "short_blocks": res.split_blocks, "short_working": res.working}


def ssd_conformance(dev) -> dict:
    """K4 against its plain version on the card over the case grid;
    returns the max (abs, relative L2) errors per x dtype."""
    import torch.nn.functional as F

    from repro_torch.kernels.ssd import kernel as k4
    from repro_torch.kernels.ssd import ssd_scan

    gen = torch.Generator(device=dev).manual_seed(6)
    errs: dict = {}

    def rnd(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    # S = 864 is a multiple of neither chunk: they halve to 32; steep
    # steps (dt about 8, |A| up to 4) make every decay past a few tokens
    # underflow
    for dt, (N, P), chunk, S, B, steep in itertools.product(
            (torch.float32, torch.bfloat16), ((128, 64), (64, 64)),
            (256, 64), (512, 864), (1, 4), (False, True)):
        H = 3
        x = rnd(B, S, H, P, scale=0.5).to(dt)
        dtv = F.softplus(rnd(B, S, H, scale=0.5) + (8.0 if steep else -1.0))
        A = -torch.exp(rnd(H, scale=0.3)) * (3.0 if steep else 1.0)
        Bm, Cm = rnd(B, S, N, scale=0.5), rnd(B, S, N, scale=0.5)
        D = rnd(H, scale=0.2)
        got = k4.ssd_kernel(x, dtv, A, Bm, Cm, D, chunk=chunk)
        torch.cuda.synchronize()
        want = ssd_scan(x, dtv, A, Bm, Cm, D, chunk=k4.chunk_len(S, chunk))
        e = ssd_close(got, want, f"K4 {dt} N={N} P={P} chunk={chunk} S={S} "
                      f"B={B} steep={steep}")
        key = ("ssd", str(dt))
        errs[key] = tuple(map(max, errs.get(key, (0.0, 0.0)), e))
    return errs


def kernel_checks(stack: contextlib.ExitStack) -> dict:
    """Enter, on ``stack``, a check of every call of the three LM kernel
    wrappers against its plain version on its own inputs
    (:func:`repro_torch.serve.bench.checked`); returns the lists of the
    calls' errors by kernel."""
    from repro_torch.kernels.flash_attention import kernel as k2
    from repro_torch.kernels.flash_attention import ops as k2_ops
    from repro_torch.kernels.flash_decode import kernel as k3
    from repro_torch.kernels.flash_decode import ops as k3_ops
    from repro_torch.kernels.ssd import kernel as k4
    from repro_torch.kernels.ssd import ssd_scan
    from repro_torch.serve import bench as sb

    def k4_plain(x, dt, A, Bm, Cm, D, *, chunk):
        return ssd_scan(x, dt, A, Bm, Cm, D,
                        chunk=k4.chunk_len(x.shape[1], chunk))

    def k2_plain(q, k, v, *, causal, window, q_offset, scale):
        return k2.flash_attention_plain(
            q, k, v, causal=causal, window=window,
            q_offset=k.shape[1] - q.shape[1] if q_offset is None
            else q_offset,
            scale=q.shape[-1] ** -0.5 if scale is None else scale)

    def k3_plain(q, k_cache, v_cache, lengths, *, window, scale):
        return k3.flash_decode_plain(
            q, k_cache, v_cache, lengths, window=window,
            scale=q.shape[-1] ** -0.5 if scale is None else scale)

    return {
        "K4": stack.enter_context(sb.checked(
            k4, "ssd_kernel", k4_plain,
            lambda g, w: ssd_close(g, w, "K4 call of the main path",
                                   SSD_CALL_TOL))),
        "K2": stack.enter_context(sb.checked(
            k2_ops, "flash_attention_fwd", k2_plain,
            lambda g, w: attn_close(g, w, "K2 call of the main path"))),
        "K3": stack.enter_context(sb.checked(
            k3_ops, "flash_decode", k3_plain,
            lambda g, w: attn_close(g, w, "K3 call of the main path"))),
    }


def worst(calls: list) -> tuple[float, float]:
    """The largest (abs, relative L2) errors over checked calls."""
    return (max((c[0][0] for c in calls), default=0.0),
            max((c[0][1] for c in calls), default=0.0))


def serve_ssm(arch: str, layers: int, dev, flush, rate: float,
              smi: str) -> list:
    """An SSM main path at full width with ``layers`` layers: prefill,
    then greedy decode, each driven once with the launch counts set to 0
    just before it and every kernel call held against its plain version;
    the logits against the plain path; timed and profiled; then K4 (and,
    in the hybrid family, K2 and K3) alone at the path's shapes.
    Returns their entries of the ``kernels`` line."""
    from repro_torch.configs import ARCHS
    from repro_torch.kernels.flash_attention import kernel as k2
    from repro_torch.kernels.flash_decode import kernel as k3
    from repro_torch.kernels.ssd import kernel as k4
    from repro_torch.kernels.ssd import ssd_scan
    from repro_torch.kernels.stencil2d import bench
    from repro_torch.models import decode_step, forward, init_caches
    from repro_torch.models import init_params
    from repro_torch.models.lm import cast
    from repro_torch.serve import bench as sb
    from repro_torch.serve import greedy_decode, make_prefill_step

    def counts():
        return {"K4": k4.launches, "K2": k2.launches, "K3": k3.launches}

    def zero_counts():
        k2.launches = k3.launches = k4.launches = 0

    name = torch.cuda.get_device_name(dev)
    cfg = ARCHS[arch].replace(attn_impl="pallas", n_layers=layers)
    groups = layers // cfg.hybrid.attn_every if cfg.hybrid else 0
    s = cfg.ssm
    H, N, P = s.n_heads(cfg.d_model), s.d_state, s.head_dim
    dt = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(0)
    t0 = time.perf_counter()
    masters = init_params(gen, cfg, device=dev)
    params = cast(masters, dt)
    torch.cuda.synchronize()
    attn = (f" + a shared attention block after every "
            f"{cfg.hybrid.attn_every} (heads={cfg.n_heads}/{cfg.n_kv_heads} "
            f"head_dim={cfg.hd} d_ff={cfg.d_ff})" if groups else "")
    print(f"lm: {arch} {layers} of {ARCHS[arch].n_layers} layers "
          f"d_model={cfg.d_model} ssd heads={H} N={N} P={P} "
          f"chunk={cfg.ssd_chunk}{attn} vocab={cfg.vocab}, bf16 weights "
          f"from seed 0 in {time.perf_counter() - t0:.1f} s", flush=True)

    # prefill: B=4 prompts of S=2048, every kernel call checked
    tokens = torch.randint(0, cfg.vocab, (PREFILL_B, PREFILL_S),
                           generator=gen, device=dev)
    batch = {"tokens": tokens}
    prefill = make_prefill_step(cfg, device=dev)
    with contextlib.ExitStack() as stack:
        calls = kernel_checks(stack)
        zero_counts()
        logits, caches = prefill(params, batch)
        torch.cuda.synchronize()
        launches = counts()
    expect = {"K4": layers, "K2": groups, "K3": 0}
    if launches != expect:
        raise AssertionError(f"{arch} prefill: launches {launches}, "
                             f"expected {expect}")
    if logits.shape != (PREFILL_B, cfg.vocab) or \
            not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"{arch} prefill: logits "
                             f"{tuple(logits.shape)} or non-finite")
    k4_call = worst(calls["K4"])
    _, k4_args, k4_kw = calls["K4"][0]
    k2_call = worst(calls["K2"])
    k2_args = calls["K2"][0][1] if groups else None
    del calls
    # the plain path on the same weights: bf16 distances are printed
    plain = cfg.replace(attn_impl="chunked")
    chunked, plain_caches = make_prefill_step(plain, device=dev)(params,
                                                                 batch)
    spread = {"logits_vs_chunked": sb.rel_l2(logits, chunked)}
    if groups:
        spread["caches_vs_chunked"] = max(
            sb.rel_l2(g, w) for g, w in zip(caches, plain_caches))
    del caches, plain_caches, chunked
    # float32 masters: every call checked, the logits gated against
    # "chunked", and the spread of two plain chunk lengths printed
    f32 = cfg.replace(dtype="float32")
    with contextlib.ExitStack() as stack:
        calls32 = kernel_checks(stack)
        got32, _ = make_prefill_step(f32, device=dev)(masters, batch)
        k4_call32, k2_call32 = worst(calls32["K4"]), worst(calls32["K2"])
        del calls32
    want32, _ = make_prefill_step(f32.replace(attn_impl="chunked"),
                                  device=dev)(masters, batch)
    check32 = lm_check(got32, want32, f"{arch} float32 prefill vs chunked",
                       **SSM_LM_TOL)
    other32, _ = make_prefill_step(
        f32.replace(attn_impl="chunked", ssd_chunk=64), device=dev)(masters,
                                                                    batch)
    spread["f32_chunk64_vs_chunk256"] = sb.rel_l2(other32, want32)
    del got32, want32, other32
    prefill_ms = bench.event_ms(lambda: prefill(params, batch), flush,
                                runs=5)
    print(f"{arch} prefill B={PREFILL_B} S={PREFILL_S}: launches {launches}"
          f"  every K4 call vs ssd_scan (max abs, rel L2): bf16 {k4_call} "
          f"f32 {k4_call32}"
          + (f"  every K2 call vs plain: bf16 {k2_call} f32 {k2_call32}"
             if groups else "")
          + f"  float32 logits vs chunked {check32}  rel L2 {spread}  "
          f"prefill_ms={prefill_ms:.3f}  "
          f"tokens/s={PREFILL_B * PREFILL_S / prefill_ms * 1e3:.0f}  "
          f"card: {smi}", flush=True)

    # greedy decode: B=4, 16-token prompts, 16 steps, bf16 caches
    prompt = torch.randint(0, cfg.vocab, (DECODE_B, DECODE_PROMPT),
                           generator=gen, device=dev)
    n_steps = DECODE_PROMPT + DECODE_STEPS - 1
    seen = []
    with contextlib.ExitStack() as stack:
        calls = kernel_checks(stack)
        zero_counts()
        out = greedy_decode(params, cfg, prompt, DECODE_STEPS, MAX_SEQ,
                            cache_dtype=dt, device=dev, on_logits=seen.append)
        torch.cuda.synchronize()
        dlaunches = counts()
        k3_call = worst(calls["K3"])
        del calls
    expect = {"K4": 0, "K2": 0, "K3": groups * n_steps}
    if dlaunches != expect:
        raise AssertionError(f"{arch} decode: launches {dlaunches}, "
                             f"expected {expect}")
    if out.shape != (DECODE_B, DECODE_STEPS) or \
            not bool(((out >= 0) & (out < cfg.vocab)).all()) or \
            not all(bool(torch.isfinite(x).all()) for x in seen):
        raise AssertionError(f"{arch} decode: tokens {tuple(out.shape)} out "
                             f"of range, or non-finite logits")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    greedy_decode(params, cfg, prompt, DECODE_STEPS, MAX_SEQ, cache_dtype=dt,
                  device=dev)
    torch.cuda.synchronize()
    greedy_ms = (time.perf_counter() - t0) * 1e3
    feed = torch.cat([prompt, out[:, :-1]], dim=1)
    # bf16: the decode steps against the plain path (the hybrid family's
    # attention by "reference", as for qwen3-0.6b) and against the
    # prefill path on the same tokens; printed
    ref_cfg = cfg.replace(attn_impl="reference")
    caches = init_caches(ref_cfg, DECODE_B, MAX_SEQ, cache_dtype=dt,
                         device=dev)
    lengths = torch.zeros((DECODE_B,), dtype=torch.int32, device=dev)
    fwd = forward(params, {"tokens": feed}, cfg)["logits"]
    vs_ref = vs_fwd = 0.0
    for t in range(n_steps):
        lengths = lengths + 1
        if groups:  # without attention the two paths are one
            want = decode_step(params, feed[:, t], caches, lengths, ref_cfg)
            vs_ref = max(vs_ref, sb.rel_l2(seen[t], want))
        vs_fwd = max(vs_fwd, sb.rel_l2(seen[t], fwd[:, t]))
    # float32: the decode recurrence against the prefill path with the
    # kernels on the same tokens, gated
    caches = init_caches(f32, DECODE_B, MAX_SEQ, cache_dtype=torch.float32,
                         device=dev)
    lengths = torch.zeros((DECODE_B,), dtype=torch.int32, device=dev)
    fwd = forward(masters, {"tokens": feed}, f32)["logits"]
    worst32 = {"rel_l2": 0.0, "max_abs_err": 0.0}
    for t in range(n_steps):
        lengths = lengths + 1
        got = decode_step(masters, feed[:, t], caches, lengths, f32)
        c = lm_check(got, fwd[:, t], f"{arch} float32 decode step {t} vs "
                     f"prefill", **SSM_LM_TOL)
        worst32 = {k: max(worst32[k], c[k]) for k in worst32}
    del fwd
    # a steady decode step: the kernel path's caches at the prompt's end
    caches = init_caches(cfg, DECODE_B, MAX_SEQ, cache_dtype=dt, device=dev)
    lengths = torch.zeros((DECODE_B,), dtype=torch.int32, device=dev)
    for t in range(n_steps):
        lengths = lengths + 1
        decode_step(params, feed[:, t], caches, lengths, cfg)
    step_ms = bench.event_ms(
        lambda: decode_step(params, feed[:, -1], caches, lengths, cfg),
        flush, runs=20)
    print(f"{arch} decode B={DECODE_B} prompt={DECODE_PROMPT} "
          f"steps={DECODE_STEPS} bf16 caches: launches {dlaunches}"
          + (f"  every K3 call vs plain {k3_call}" if groups else "")
          + "  per-step logits rel L2: "
          + (f"vs reference attention {vs_ref:.3e}, " if groups else "")
          + f"vs prefill {vs_fwd:.3e}  float32 decode vs prefill {worst32}  "
          f"greedy_ms={greedy_ms:.1f} ({n_steps} steps, "
          f"{greedy_ms / n_steps:.3f} ms/step incl. host)  "
          f"step_ms={step_ms:.3f} at length {int(lengths[0])}  "
          f"tokens/s={DECODE_B / step_ms * 1e3:.0f}  card: {smi}",
          flush=True)
    for tag, fn, runs, plain_wall in (
            ("prefill", lambda: prefill(params, batch), 1, prefill_ms),
            ("decode step", lambda: decode_step(params, feed[:, -1], caches,
                                                lengths, cfg), 5, step_ms)):
        wall, dev_ms, top = sb.device_share(fn, runs)
        if dev_ms == 0:
            print(f"profile {arch} {tag}: wall_ms={wall:.3f}, the profiler "
                  f"saw no device time: busy share not measured", flush=True)
            continue
        print(f"profile {arch} {tag}: device_ms={dev_ms:.3f}  profiled "
              f"wall_ms={wall:.3f} (busy >= {100 * dev_ms / wall:.1f} %)  "
              f"event ms={plain_wall:.3f} (busy ~ "
              f"{100 * dev_ms / plain_wall:.1f} %)  top kernels (ms): "
              + "; ".join(f"{k} {t:.3f}" for k, t in top), flush=True)
    del caches

    # K4 alone on the first layer's inputs of the driven prefill
    x, dtv, A, Bm, Cm, D = k4_args
    L = k4.chunk_len(x.shape[1], k4_kw["chunk"])
    want = ssd_scan(x, dtv, A, Bm, Cm, D, chunk=L)
    y, k4_run = k4.prepare(x, dtv, A, Bm, Cm, D, **k4_kw)
    blocks = "+".join(map(str, k4_run()))  # the four launches' grids
    k4_err, k4_rel = ssd_close(y, want, f"K4 at the {arch} prefill shape, "
                               f"timed launch", SSD_CALL_TOL)
    k4_ms = bench.device_ms(k4_run, flush)
    k4_plain_ms = bench.device_ms(
        lambda: ssd_scan(x, dtv, A, Bm, Cm, D, chunk=L), flush, runs=5)
    flops, nbytes = sb.ssd_work(x, dtv, Bm, Cm, D, L)
    scratch_bytes = sb.ssd_scratch_bytes(x, N, L)
    # measured against the tensor-core bound: the nominal float32 work at
    # the dense TF32 rate (3xTF32 executes two to three times as much);
    # the float32-FMA bound printed beside it
    k4_bound, k4_by = sb.bound_ms(flops, nbytes, sb.tf32_peak(name), rate)
    f32_bound, f32_by = sb.bound_ms(flops, nbytes, sb.f32_peak(name), rate)
    scratch_bound = (nbytes + scratch_bytes) / rate * 1e3
    print(f"K4 ({arch}: B={x.shape[0]} S={x.shape[1]} H={H} P={P} N={N} "
          f"L={L} x {str(x.dtype).replace('torch.', '')}): ms={k4_ms:.4f}  "
          f"plain_ms={k4_plain_ms:.3f}  flops={flops:.3e} bytes={nbytes} "
          f"+ scratch_bytes={scratch_bytes} between the passes  "
          f"bound_ms={k4_bound:.4f} ({k4_by}; TF32 tensor cores at "
          f"{sb.tf32_peak(name) / 1e12:.0f} TFLOP/s, bytes at "
          f"{rate / 1e12:.2f} TB/s)  float32-FMA bound_ms={f32_bound:.4f} "
          f"({f32_by}; {sb.f32_peak(name) / 1e12:.0f} TFLOP/s)  bytes with "
          f"the scratch {scratch_bound:.4f} ms  "
          f"{flops / k4_ms / 1e9:.2f} TFLOP/s  "
          f"{100 * k4_ms * layers / prefill_ms:.1f} % of prefill  "
          f"blocks={blocks}  max_abs_err={k4_err:.3e}  "
          f"rel_l2_err={k4_rel:.3e}  card: {smi}", flush=True)
    entries = [{
        "name": f"ssd[{arch} prefill B={PREFILL_B} S={PREFILL_S} H={H} "
                f"P={P} N={N} L={L} x bf16]",
        "route": "cuda", "source": K4_SOURCE, "replaces": K4_REPLACES,
        "launches": launches["K4"], "max_abs_err": k4_call[0], "ms": k4_ms,
        "plain_ms": k4_plain_ms, "bound_ms": k4_bound, "bound_by": k4_by,
        "library_ms": None, "rel_l2_err": k4_call[1], "blocks": blocks,
        "f32_bound_ms": f32_bound, "scratch_bytes": scratch_bytes,
        "prefill_ms": prefill_ms, "decode_step_ms": step_ms}]
    del x, dtv, A, Bm, Cm, D, k4_args, y, want
    if groups:
        q, k, v = k2_args
        e2 = k2_alone(q, k, v, arch, flush, rate, smi, calls=groups,
                      prefill_ms=prefill_ms)
        del q, k, v, k2_args
        e3 = k3_alone(DECODE_B, cfg.n_heads, cfg.n_kv_heads, cfg.hd, dt, gen,
                      arch, flush, rate, smi)
        entries += [
            {"name": f"flash_attention[{arch} prefill B={PREFILL_B} "
                     f"S={PREFILL_S} causal bf16]",
             "launches": launches["K2"], **e2, "max_abs_err": k2_call[0],
             "rel_l2_err": k2_call[1], "prefill_ms": prefill_ms},
            {"name": f"flash_decode[{arch} B={DECODE_B} S={MAX_SEQ} "
                     f"bf16 cache]",
             "launches": dlaunches["K3"], **e3, "max_abs_err": k3_call[0],
             "rel_l2_err": k3_call[1], "decode_step_ms": step_ms}]
    return entries


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core import ALL_PROGRAMS, compile_program
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import kernel as k2
    from repro_torch.kernels.flash_decode import kernel as k3
    from repro_torch.kernels.ssd import kernel as k4
    from repro_torch.kernels.stencil2d import bench
    from repro_torch.kernels.stencil2d import kernel as k1

    # float32 products in full float32 on the card (the plain versions)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    smi = bench.smi_line()
    rate = bench.hbm_rate(name)

    # 1. environment
    print(f"env: python {sys.version.split()[0]}  torch {torch.__version__}  "
          f"cuda {torch.version.cuda}  nvcc "
          f"{build.nvcc_version().strip().splitlines()[-1]}  card: {smi}",
          flush=True)

    # 2. build every kernel in parallel: K1 for the 15 programs, K2-K4
    plans = {n: compile_program(b(), backend="interp_torch",
                                device=dev).kernel_plan
             for n, b in sorted(ALL_PROGRAMS.items())}
    calls = [c for kp in plans.values() for c in kp.calls if c.has_grid]
    t0 = time.perf_counter()
    _, built = build.build([*(k1.job(c) for c in calls), k2.job(), k3.job(),
                            k4.job()])
    print(f"build: {len(calls)} stencil calls + flash attention + flash "
          f"decode + ssd, {built} sources compiled in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    hmma = {}
    for tag, kjob in (("K2", k2.job()), ("K4", k4.job())):
        hmma[tag] = build.sass_count(kjob, "HMMA")
        print(f"build: {tag}'s library has {hmma[tag]} HMMA (tensor-core) "
              f"instructions (cuobjdump -sass {build.library_path(kjob)})",
              flush=True)
        if hmma[tag] == 0:
            raise AssertionError(f"{tag}'s library has no tensor-core "
                                 f"instruction")
    heat = next(c for c in plans["heat3d"].calls if c.has_grid)
    for tag, kjob in (("K4", k4.job()), ("K1 heat3d", k1.job(heat))):
        print(f"build: {tag} resources (cuobjdump -res-usage):\n"
              f"{build.resource_usage(kjob)}", flush=True)

    # 3. conformance: "cuda" against "interp_torch", both on the card;
    # the plane-window programs also in small forced plane chunks
    for n, b in sorted(ALL_PROGRAMS.items()):
        prog = b()
        arrs = bench.make_inputs(n, plans[n], CONFORMANCE_DIMS, 7, dev)
        want = compile_program(prog, backend="interp_torch",
                               device=dev).fn(**arrs)
        runs = [{"chunk": SMALL_CHUNK}, {"chunk": None}]
        if any(k1.layout(c).planar for c in plans[n].calls if c.has_grid):
            runs[1:1] = [{"chunk": SMALL_CHUNK,
                          "plane_chunk": SMALL_PLANE_CHUNK},
                         {"chunk": 1, "plane_chunk": 1}]
        errs = []
        for opts in runs:
            got = compile_program(prog, backend="cuda", device=dev,
                                  **opts).fn(**arrs)
            torch.cuda.synchronize()
            errs.append(max_err(got, want, f"conformance/{n}/{opts}"))
        print(f"conformance {n:22s} max_abs_err "
              + "  ".join(f"{o}: {e:.3e}" for o, e in zip(runs, errs)),
              flush=True)

    # 4. the main path at real size, then the plane-window calls
    flush = bench.l2_flusher(dev)
    entries = [drive(n, dims, dev, flush, rate, smi)
               for n, dims in bench.MAIN_PATH + bench.PLANE_WINDOW_PATH]

    # 4b. the compiler's entry points and PlanServe, through K1
    entries += compiler_phase(dev, flush, rate, smi)

    # 5. attention conformance on the card
    t0 = time.perf_counter()
    for (kern, dts), (e, r) in sorted(attention_conformance(dev).items()):
        print(f"conformance {kern:15s} {dts:30s} max_abs_err: {e:.3e}  "
              f"rel_l2_err: {r:.3e}", flush=True)
    print(f"attention conformance: {time.perf_counter() - t0:.1f} s",
          flush=True)

    # 6. the LM main path at full width
    entries += serve_lm(dev, flush, rate, smi)

    # 7. SSD conformance on the card
    t0 = time.perf_counter()
    for (kern, dts), (e, r) in sorted(ssd_conformance(dev).items()):
        print(f"conformance {kern:15s} {dts:30s} max_abs_err: {e:.3e}  "
              f"rel_l2_err: {r:.3e}", flush=True)
    print(f"ssd conformance: {time.perf_counter() - t0:.1f} s", flush=True)

    # 8. the SSM main paths at full width
    for arch, layers in SSM_PATHS:
        entries += serve_ssm(arch, layers, dev, flush, rate, smi)

    # 9. the kernels line, the card, and the result
    for e in entries:
        for tag, source in (("K2", K2_SOURCE), ("K4", K4_SOURCE)):
            if e["source"] == source:
                e["hmma"] = hmma[tag]
    print(json.dumps({"kernels": entries}))
    print(bench.smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
