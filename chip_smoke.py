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
   lengths; then the shapes of phase 8b's paths: K2 not causal with one
   query row and with Sq = 448 over Skv = 1536 (D = 64), causal at GQA
   groups 3 (D = 64) and 8 (D = 128), and K3 at groups 3 and 8;
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
8b. the moe, encdec and vlm paths at full width in bf16 with
   ``attn_impl="pallas"``, random weights from a seeded generator:
   granite-moe-3b-a800m at full depth (32 layers, 40 experts top-8;
   prefill of 4 x 2048 launches K2 32 times, each decode step K3 32
   times), whisper-small at full depth (12 encoder and 12 decoder
   layers; prefill of 4 stub frame sequences of 1536 and 448-token
   prompts launches K2 36 times: encoder, decoder and cross attention;
   each decode step K3 12 times and K2 12 times at one query row) and
   qwen2-vl-72b cut from 80 to 8 layers (prefill of 4 x 2048, a 32 x 32
   patch image then text with M-RoPE positions: K2 8 times at GQA group
   8; each decode step K3 8 times).  The float32 prefill is gated
   against ``"chunked"`` (granite only for gross faults, with the count
   of token-layers whose expert choice differs), whisper's float32
   decode over the prefill's encoder K/V against the prefill's logits;
   bf16 prefill and greedy decode (whisper's also over cross caches
   holding the prefill's encoder K/V) are held against the plain paths
   and printed, every K2 and K3 call of them against its plain version;
   then timed, profiled, and K2 at every shape of the driven runs and K3
   alone beside their plain versions, bounds and SDPA;
9. the ``kernels`` line (printed after phase 10): for each kernel and
   main path (K1's ``compile_batched`` and PlanServe paths of phase 4b
   among them), its launches in one driven run (counts set to zero just
   before it), its error against the plain version, its times and its
   bound;
10. training on the card (no kernel lies on the training path: the
   reference trains on ``attn_impl="chunked"``): (a) a smoke-width
   float32 train step of each of the six families on the card and on
   the CPU from the same state, the loss within ``rtol=1e-5`` and every
   parameter after a second step within ``atol=2e-5, rtol=1e-4``; (b)
   qwen3-0.6b and (c) mamba2-130m at full width (float32 masters, bf16
   compute, ``remat="full"``, B = 4 x 2048 synthetic tokens, 10 steps
   of ``train_loop``'s step function): step time by CUDA events,
   tokens/s, the profiler's device busy share, peak memory, each step's
   loss, gradient norm, learning rate, clip scale and update size, the
   losses (finite; every step's update at least 0.1 x its learning
   rate; the first batch's loss after the last step below its loss
   before the first; for qwen3-0.6b the last step's loss below the
   first's; two microbatches' first loss within 2e-3 of one's) and the
   model FLOPs a step against 989 TFLOP/s; before training, a gradient
   probe in float32 (the norm at 2, 8 and all layers, and its change
   under a 1e-7 relative perturbation of the weights); (d) exact resume at qwen3-0.6b's width cut to 2 layers (5
   straight steps against 3, a crash and 2 resumed: every leaf within
   1e-6); (e) the trained qwen3-0.6b masters, as leaves that require
   grad, cast to bf16 and served with ``attn_impl="pallas"``: a prefill
   of 4 x 2048 through K2 (28 launches) within the bf16 gate of
   ``"chunked"``, 8 greedy decode steps through K3 (28 a step), every
   K2 and K3 call held against its plain version; (f) a
   train step through the forward-only kernels raises;
11. the mesh on the card (no kernel lies on it), over a (1, 1)
   ``make_host_mesh`` of a one-rank NCCL group on 127.0.0.1: (a) phase
   10b's first step (qwen3-0.6b, full width and depth, the same masters
   and batch) with parameters, AdamW moments and batch laid out as
   DTensors by ``param_specs`` under ``use_mesh``, its loss within
   ``rtol=1e-5`` and every parameter within ``atol=3e-5, rtol=1e-3`` of
   the unsharded step's, both timed (median of 5); (b) qwen3-0.6b's
   prefill (4 x 2048) and one decode step through ``specs.build_cell``'s
   cells on the mesh, bf16, within the bf16 logit gate of the unsharded
   ``make_prefill_step`` and ``make_decode_step``, the decode's new K/V
   rows bit for bit (``torch.equal``: one rank runs the unsharded ops);
   (c) the unsharded step counted by ``FlopCounterMode`` and the dry
   run's byte counter, through ``Roofline`` with the H100's
   constants, beside its measured time; (d) the dry run's gate cell
   (mamba2-130m x decode_32k on the 16 x 16 mesh of 256 fake ranks), a
   host-only subprocess that must print ``dry-run complete: 1 ok``.

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
import math
import pathlib
import statistics
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
#: Phase 5's K2 shapes of the moe, encdec and vlm paths: (B, Sq, Skv, H,
#: KVH, D, causal).
NEW_K2_SHAPES = ((4, 1, 1536, 12, 12, 64, False),
                 (2, 448, 1536, 12, 12, 64, False),
                 (2, 333, 333, 24, 8, 64, True),
                 (1, 300, 300, 64, 8, 128, True))
#: Phase 5's K3 shapes of those paths: (H, KVH, D), groups 3 and 8.
NEW_K3_SHAPES = ((24, 8, 64), (64, 8, 128))
#: Phase 8b, the moe, encdec and vlm paths at full width: (arch, layers).
#: granite-moe-3b-a800m and whisper-small at full depth; qwen2-vl-72b cut
#: from 80 to 8 layers, as its full depth does not fit one card (145 GB
#: of bf16 weights against 80 GB).
FAMILY_PATHS = (("granite-moe-3b-a800m", 32), ("whisper-small", 12),
                ("qwen2-vl-72b", 8))
#: whisper-small's decoder prompts and caches: its text context of 448
#: tokens (arXiv:2212.04356).
WHISPER_TEXT = 448
#: qwen2-vl-72b's prefill: a VLM_IMAGE x VLM_IMAGE patch image, then text.
VLM_IMAGE = 32
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
#: Phase 10, training on the card.  (a) every family at smoke width in
#: float32, card against CPU: the loss at the reference's own float32
#: gate and every parameter after a step at the tolerance of its
#: microbatch test (tests/test_infra.py).
TRAIN_FAMILIES = (("dense", "qwen3-0.6b"), ("moe", "granite-moe-3b-a800m"),
                  ("ssm", "mamba2-130m"), ("hybrid", "zamba2-2.7b"),
                  ("encdec", "whisper-small"), ("vlm", "qwen2-vl-72b"))
TRAIN_FAMILY_B, TRAIN_FAMILY_S = 4, 64
TRAIN_LOSS_RTOL = 1e-5
TRAIN_STEP_TOL = dict(atol=2e-5, rtol=1e-4)
#: (b, c) qwen3-0.6b and mamba2-130m at full width: steps of B x S
#: synthetic tokens; two microbatches' first loss within TRAIN_MB_RTOL
#: of one's (bf16 compute, two summation orders).
TRAIN_B, TRAIN_S, TRAIN_STEPS = 4, 2048, 10
TRAIN_MB_RTOL = 2e-3
#: Every step must move the parameters: the root mean square of its
#: change over all of them at least UPDATE_FLOOR times the step's
#: learning rate.  AdamW moves a parameter by about lr (by lr * sign(g)
#: at the first step) wherever the clipped gradient lies well above
#: eps = 1e-8, and by far less where it does not.
UPDATE_FLOOR = 0.1
#: The architectures whose last step's loss must lie below the first's
#: (every one: the first batch's loss after the last step below its
#: loss before the first).  Not mamba2-130m: at this initialisation its
#: gradient explodes with depth, in the reference too
#: (tests/test_torch_train.py::
#: test_ssm_gradient_norm_grows_with_depth_as_in_reference, and the
#: gradient probe's line), and its per-step losses stay within the
#: batches' spread over 10 steps.
LAST_BELOW_FIRST = ("qwen3-0.6b",)
#: The gradient probe before training: float32, the first sequence of
#: the first batch, the model cut to each of PROBE_DEPTHS layers (and
#: whole); the gradient's norm and its relative change when every
#: weight is scaled by 1 + PROBE_EPS * N(0, 1).
PROBE_DEPTHS, PROBE_EPS = (2, 8), 1e-7
#: The model-FLOPs share's peak: dense bf16 on the H100 (989 TFLOP/s).
BF16_PEAK = 989e12
#: (d) exact resume at qwen3-0.6b's width cut to RESUME_LAYERS layers
#: (2.2 GB a checkpoint), B = TRAIN_B sequences of RESUME_S tokens.
RESUME_LAYERS, RESUME_S = 2, 512
#: (e) greedy decode steps of the trained model through K3.
TRAIN_DECODE_STEPS = 8
#: Phase 11, the mesh on the card.  (a) the sharded train step against
#: the unsharded one at the reference's sharded-step tolerances
#: (tests/test_distributed.py), each timed over MESH_STEPS steps.
MESH_LOSS_RTOL = 1e-5
MESH_PARAM_TOL = dict(atol=3e-5, rtol=1e-3)
MESH_STEPS = 5
#: (d) the dry run's gate cell, run host-only in a subprocess.
DRYRUN_CELL = ("mamba2-130m", "decode_32k")


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
    # the moe, encdec and vlm paths' shapes.  K2 not causal with one query
    # row and with Sq = 448 over Skv = 1536 (whisper-small's cross
    # attention, D = 64, group 1), causal at group 3 (granite-moe-3b: 24
    # heads over 8, D = 64) and group 8 (qwen2-vl-72b: 64 over 8, D =
    # 128), ragged where the paths are not; K3 at groups 3 and 8
    for dt, (B, Sq, Skv, H, KVH, D, causal) in itertools.product(
            (torch.float32, torch.bfloat16), NEW_K2_SHAPES):
        q = rnd(B, Sq, H, D, dtype=dt)
        k = rnd(B, Skv, KVH, D, dtype=dt)
        v = rnd(B, Skv, KVH, D, dtype=dt)
        got = k2.flash_attention_fwd(q, k, v, causal=causal)
        torch.cuda.synchronize()
        want = k2.flash_attention_plain(q, k, v, causal=causal, window=None,
                                        q_offset=Skv - Sq, scale=D ** -0.5)
        e = attn_close(got, want, f"K2 {dt} B={B} Sq={Sq} Skv={Skv} H={H} "
                       f"KVH={KVH} D={D} causal={causal}")
        key = ("flash_attention", str(dt))
        errs[key] = tuple(map(max, errs.get(key, (0.0, 0.0)), e))
    for dt, (H, KVH, D) in itertools.product(
            (torch.float32, torch.bfloat16), NEW_K3_SHAPES):
        q = rnd(3, H, D, dtype=dt)
        kc = rnd(3, 1000, KVH, D, dtype=dt)
        vc = rnd(3, 1000, KVH, D, dtype=dt)
        lengths = torch.tensor([1, 517, 1000], dtype=torch.int32, device=dev)
        got = k3.flash_decode(q, kc, vc, lengths)
        torch.cuda.synchronize()
        want = k3.flash_decode_plain(q, kc, vc, lengths, window=None,
                                     scale=D ** -0.5)
        e = attn_close(got, want, f"K3 {dt} H={H} KVH={KVH} D={D}")
        key = ("flash_decode", f"{dt}/{dt}")
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


def profile(arch: str, runs) -> None:
    """Where the device time goes (torch.profiler), for each ``(tag, fn,
    runs, event_ms)``: the kernels' device time over the profiled wall
    time (a lower bound of the busy share, the profiler adds host time
    to every operator) and over the same work's CUDA-event time
    ``event_ms`` without the profiler."""
    from repro_torch.serve import bench as sb

    for tag, fn, n, plain_wall in runs:
        wall, dev_ms, top = sb.device_share(fn, n)
        if dev_ms == 0:
            print(f"profile {arch} {tag}: wall_ms={wall:.3f}, the profiler "
                  f"saw no device time: busy share not measured", flush=True)
            continue
        print(f"profile {arch} {tag}: device_ms={dev_ms:.3f}  profiled "
              f"wall_ms={wall:.3f} (busy >= {100 * dev_ms / wall:.1f} %)  "
              f"event ms={plain_wall:.3f} (busy ~ "
              f"{100 * dev_ms / plain_wall:.1f} %)  top kernels (ms): "
              + "; ".join(f"{k} {t:.3f}" for k, t in top), flush=True)


def launch_counts() -> dict:
    """The launch counts of the LM kernel wrappers K2-K4."""
    from repro_torch.kernels.flash_attention import kernel as k2
    from repro_torch.kernels.flash_decode import kernel as k3
    from repro_torch.kernels.ssd import kernel as k4

    return {"K2": k2.launches, "K3": k3.launches, "K4": k4.launches}


def zero_launch_counts() -> None:
    from repro_torch.kernels.flash_attention import kernel as k2
    from repro_torch.kernels.flash_decode import kernel as k3
    from repro_torch.kernels.ssd import kernel as k4

    k2.launches = k3.launches = k4.launches = 0


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
    profile(LM_ARCH, (
        ("prefill", lambda: prefill(params, {"tokens": tokens}), 1,
         prefill_ms),
        ("decode step", lambda: decode_step(params, feed[:, -1], caches,
                                            lengths, cfg), 5, step_ms)))
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
             calls: int, prefill_ms: float, causal: bool = True,
             part: str = "prefill") -> dict:
    """K2 alone on (q, k, v) (``causal``, or not): its wrapper against the
    plain version, then its launch timed beside the plain version, one
    ``scaled_dot_product_attention`` call and its bound, and its
    ``calls`` launches' share of ``prefill_ms`` (the time of the driven
    ``part``).  Returns the fields of its ``kernels`` entry but the name
    and launches."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import kernel as k2
    from repro_torch.kernels.stencil2d import bench
    from repro_torch.serve import bench as sb

    B, S, H, D = q.shape
    KVH, Skv = k.shape[2], k.shape[1]
    run = dict(causal=causal, window=None, q_offset=Skv - S,
               scale=D ** -0.5)
    want = k2.flash_attention_plain(q, k, v, **run)
    err, rel = attn_close(k2.flash_attention_fwd(q, k, v, **run), want,
                          f"K2 at the {tag} shape")
    # time the launch alone, through the helper the wrapper launches by
    o, k2_run = k2.prepare(q, k, v, **run)
    blocks = k2_run()
    attn_close(o, want, f"K2 at the {tag} shape, timed launch")
    ms = bench.device_ms(k2_run, flush)
    plain_ms = bench.device_ms(
        lambda: k2.flash_attention_plain(q, k, v, **run), flush, runs=5)
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    lib_ms = bench.device_ms(
        lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                               enable_gqa=True), flush)
    flops, nbytes = sb.attention_work(q, k, v, causal=causal, window=None,
                                      q_offset=Skv - S)
    bound, by = sb.bound_ms(flops, nbytes,
                            sb.bf16_peak(torch.cuda.get_device_name(q.device)),
                            rate)
    earlier = EARLIER_MS.get(("K2", tag))
    print(f"K2 ({tag}: B={B} Sq={S} Skv={Skv} H={H} KVH={KVH} D={D} "
          f"{'causal' if causal else 'non-causal'} "
          f"{str(q.dtype).replace('torch.', '')}): ms={ms:.4f} "
          + (f"(the earlier kernel, with its launch: {earlier:.4f})  "
             if earlier else "")
          + f"plain_ms={plain_ms:.3f}  sdpa_ms={lib_ms:.4f}  "
          f"flops={flops:.3e} bytes={nbytes}  bound_ms={bound:.4f} ({by})  "
          f"{flops / ms / 1e9:.1f} TFLOP/s  "
          f"{calls} calls {100 * ms * calls / prefill_ms:.1f} % of {part}  "
          f"blocks={blocks}  max_abs_err={err:.3e}  "
          f"rel_l2_err={rel:.3e}  card: {smi}", flush=True)
    return {"route": "cuda", "source": K2_SOURCE, "replaces": K2_REPLACES,
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": by, "library_ms": lib_ms,
            "rel_l2_err": rel, "blocks": str(blocks)}


def k3_alone(B: int, H: int, KVH: int, D: int, dt, gen, tag: str, flush,
             rate: float, smi: str, max_seq: int = MAX_SEQ) -> dict:
    """K3 alone over a full ``max_seq``-position cache of random values
    from ``gen``: its wrapper against the plain version, then its launch
    timed beside the plain version, one SDPA call and its bound; then at
    the main path's lengths.  Returns the fields of its ``kernels``
    entry but the name and launches."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_decode import kernel as k3
    from repro_torch.kernels.stencil2d import bench
    from repro_torch.serve import bench as sb

    dev = gen.device
    q = torch.randn((B, H, D), generator=gen, device=dev).to(dt)
    kc = torch.randn((B, max_seq, KVH, D), generator=gen, device=dev).to(dt)
    vc = torch.randn((B, max_seq, KVH, D), generator=gen, device=dev).to(dt)
    lengths = torch.full((B,), max_seq, dtype=torch.int32, device=dev)
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
    earlier = EARLIER_MS.get(("K3", tag))
    print(f"K3 ({tag}: B={B} H={H} KVH={KVH} D={D} S=lengths={max_seq} "
          f"{str(dt).replace('torch.', '')} cache, blocks={blocks} "
          f"split+combine, {res.working} split blocks holding keys): "
          f"ms={ms:.4f} "
          + (f"(the earlier kernel, with its launch: {earlier:.4f})  "
             if earlier else "")
          + f"plain_ms={plain_ms:.4f}  "
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
                           f"of {max_seq}, timed launch")
    short_ms = bench.device_ms(k3_short, flush)
    flops, nbytes = sb.decode_work(q, kc, vc, short, window=None)
    short_bound, short_by = sb.bound_ms(flops, nbytes, peak, rate)
    print(f"K3 ({tag} at the main path's lengths {int(short[0])} of "
          f"{max_seq}): ms={short_ms:.4f}  split blocks launched="
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
    from repro_torch.kernels.ssd import kernel as k4
    from repro_torch.kernels.ssd import ssd_scan
    from repro_torch.kernels.stencil2d import bench
    from repro_torch.models import decode_step, forward, init_caches
    from repro_torch.models import init_params
    from repro_torch.models.lm import cast
    from repro_torch.serve import bench as sb
    from repro_torch.serve import greedy_decode, make_prefill_step

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
        zero_launch_counts()
        logits, caches = prefill(params, batch)
        torch.cuda.synchronize()
        launches = launch_counts()
    expect = {"K4": layers, "K2": groups, "K3": 0}
    if launches != expect:
        raise AssertionError(f"{arch} prefill: launches {launches}, "
                             f"expected {expect}")
    if logits.shape != (PREFILL_B, cfg.vocab) or \
            not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"{arch} prefill: logits "
                             f"{tuple(logits.shape)} or non-finite")
    k4_call = worst(calls["K4"])
    _, k4_args, k4_kw, _ = calls["K4"][0]
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
        zero_launch_counts()
        out = greedy_decode(params, cfg, prompt, DECODE_STEPS, MAX_SEQ,
                            cache_dtype=dt, device=dev, on_logits=seen.append)
        torch.cuda.synchronize()
        dlaunches = launch_counts()
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
    profile(arch, (
        ("prefill", lambda: prefill(params, batch), 1, prefill_ms),
        ("decode step", lambda: decode_step(params, feed[:, -1], caches,
                                            lengths, cfg), 5, step_ms)))
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


def image_then_text(n: int, S: int, B: int, dev) -> torch.Tensor:
    """M-RoPE positions (3, B, S) of an n x n patch image (t = 0, h = row,
    w = column) followed by text whose three components are equal and
    continue from the image's largest component plus one."""
    r = torch.arange(n * n, device=dev)
    img = torch.stack([torch.zeros_like(r), r // n, r % n])
    start = int(img.max()) + 1
    text = torch.arange(start, start + S - n * n, device=dev).expand(3, -1)
    return torch.cat([img, text], dim=1)[:, None].expand(3, B, S)


def family_batch(cfg, gen, dev) -> dict:
    """A family path's prefill batch: B x S tokens from ``gen``; whisper
    at its text context with the stub frontend's frame embeddings (B,
    enc_seq, d) from ``gen``, as the reference's ``enc_frames`` stub;
    qwen2-vl with the M-RoPE positions of an image, then text."""
    S = WHISPER_TEXT if cfg.family == "encdec" else PREFILL_S
    batch = {"tokens": torch.randint(0, cfg.vocab, (PREFILL_B, S),
                                     generator=gen, device=dev)}
    if cfg.family == "encdec":
        batch["enc_frames"] = torch.randn(
            (PREFILL_B, cfg.encdec.enc_seq, cfg.d_model), generator=gen,
            device=dev)
    if cfg.mrope_sections is not None:
        batch["positions"] = image_then_text(VLM_IMAGE, S, PREFILL_B, dev)
    return batch


@contextlib.contextmanager
def recorded_routes():
    """While active, the expert choice (B, S, K, sorted) of every
    ``moe.route`` call is appended to the yielded list."""
    from repro_torch.models import moe

    real, seen = moe.route, []

    def wrapper(p, x, cfg):
        out = real(p, x, cfg)
        seen.append(out[2].sort(-1).values)
        return out

    moe.route = wrapper
    try:
        yield seen
    finally:
        moe.route = real


def route_mismatches(got: list, want: list) -> int:
    """Token-layers whose expert choice differs between two runs."""
    if len(got) != len(want):
        raise AssertionError(f"{len(got)} routed layers against {len(want)}")
    return sum(int((g != w).any(-1).sum()) for g, w in zip(got, want))


def by_signature(calls: list) -> list:
    """Checked calls grouped by signature, in first-call order: (args,
    kwargs, the number of calls, their worst (abs, relative L2) errors)."""
    groups: dict = {}
    for errs, args, kw, sig in calls:
        if sig not in groups:
            groups[sig] = [args, kw, 0, (0.0, 0.0)]
        g = groups[sig]
        g[2] += 1
        g[3] = tuple(map(max, g[3], errs))
    return list(groups.values())


def serve_family(arch: str, layers: int, dev, flush, rate: float,
                 smi: str) -> list:
    """A moe, encdec or vlm path at full width with ``layers`` layers:
    the float32 prefill gated against ``"chunked"``; the bf16 prefill,
    then decode, each driven once with the launch counts set to 0 just
    before it and every K2 and K3 call held against its plain version;
    timed and profiled; then K2 and K3 alone at the path's shapes.
    Returns their entries of the ``kernels`` line."""
    from repro_torch.configs import ARCHS
    from repro_torch.kernels.stencil2d import bench
    from repro_torch.models import decode_step, forward, init_caches
    from repro_torch.models import init_params
    from repro_torch.models.lm import cast
    from repro_torch.serve import bench as sb
    from repro_torch.serve import (greedy_decode, make_decode_step,
                                   make_prefill_step)

    cfg = ARCHS[arch].replace(attn_impl="pallas", n_layers=layers)
    moe, encdec = cfg.family == "moe", cfg.family == "encdec"
    n_attn = layers * 3 if encdec else layers  # K2 calls of a prefill
    dt = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(0)
    t0 = time.perf_counter()
    masters = init_params(gen, cfg, device=dev)
    torch.cuda.synchronize()
    what = (f"{cfg.moe.n_experts} experts top-{cfg.moe.top_k} d_ff_expert="
            f"{cfg.moe.d_ff_expert}" if moe else f"d_ff={cfg.d_ff}")
    if encdec:
        what += (f" encoder {cfg.encdec.n_enc_layers} layers over "
                 f"enc_seq={cfg.encdec.enc_seq} stub frames")
    if cfg.mrope_sections:
        what += f" M-RoPE sections {cfg.mrope_sections}"
    print(f"lm: {arch} ({cfg.family}) {layers} of {ARCHS[arch].n_layers} "
          f"layers"
          + (f" (cut from {ARCHS[arch].n_layers}: the full depth's bf16 "
             f"weights do not fit the card)"
             if layers < ARCHS[arch].n_layers else "")
          + f" d_model={cfg.d_model} heads={cfg.n_heads}/{cfg.n_kv_heads} "
          f"head_dim={cfg.hd} {what} vocab={cfg.vocab}, float32 masters "
          f"from seed 0 in {time.perf_counter() - t0:.1f} s", flush=True)
    batch = family_batch(cfg, gen, dev)
    S = batch["tokens"].shape[1]
    route_rec = recorded_routes if moe else contextlib.nullcontext

    # float32: every call checked, the logits gated against "chunked"
    # (granite only for gross faults: a router tie broken by a 1e-7
    # difference sends a token to another expert), the expert choices
    # of the two paths compared
    f32 = cfg.replace(dtype="float32")
    with contextlib.ExitStack() as stack:
        calls32 = kernel_checks(stack)
        routes32 = stack.enter_context(route_rec())
        zero_launch_counts()
        got32, caches32 = make_prefill_step(f32, device=dev)(masters, batch)
        torch.cuda.synchronize()
        launches32 = launch_counts()
        k2_call32 = worst(calls32["K2"])
        del calls32
    if launches32 != {"K2": n_attn, "K3": 0, "K4": 0}:
        raise AssertionError(f"{arch} float32 prefill: launches "
                             f"{launches32}, expected K2 x {n_attn}")
    with route_rec() as plain_routes32:
        want32, _ = make_prefill_step(f32.replace(attn_impl="chunked"),
                                      device=dev)(masters, batch)
    check32 = lm_check(got32, want32, f"{arch} float32 prefill vs chunked",
                       **(SSM_LM_TOL if moe else LM_TOL["float32"]))
    mismatch32 = route_mismatches(routes32, plain_routes32) if moe else None
    del got32, want32, routes32, plain_routes32
    dec32 = None
    if encdec:
        # the decode recurrence over the prefill's encoder K/V against
        # the prefill's own logits on the same tokens, gated
        n = DECODE_PROMPT + DECODE_STEPS - 1
        caches = init_caches(f32, PREFILL_B, WHISPER_TEXT,
                             cache_dtype=torch.float32, device=dev)
        caches["cross_k"].copy_(caches32[1][0])
        caches["cross_v"].copy_(caches32[1][1])
        fwd = forward(masters, {**batch, "tokens": batch["tokens"][:, :n]},
                      f32)["logits"]
        lengths = torch.zeros((PREFILL_B,), dtype=torch.int32, device=dev)
        dec32 = {"rel_l2": 0.0, "max_abs_err": 0.0}
        for t in range(n):
            lengths = lengths + 1
            got = decode_step(masters, batch["tokens"][:, t], caches,
                              lengths, f32)
            c = lm_check(got, fwd[:, t], f"{arch} float32 decode step {t} "
                         f"vs prefill", **LM_TOL["float32"])
            dec32 = {k: max(dec32[k], c[k]) for k in dec32}
        del caches, fwd
    del caches32
    params = cast(masters, dt)
    del masters
    torch.cuda.empty_cache()

    # bf16 prefill, every call checked
    prefill = make_prefill_step(cfg, device=dev)
    with contextlib.ExitStack() as stack:
        calls = kernel_checks(stack)
        routes = stack.enter_context(route_rec())
        zero_launch_counts()
        logits, caches = prefill(params, batch)
        torch.cuda.synchronize()
        launches = launch_counts()
        k2_call, k2_groups = worst(calls["K2"]), by_signature(calls["K2"])
        del calls
    if launches != {"K2": n_attn, "K3": 0, "K4": 0}:
        raise AssertionError(f"{arch} prefill: launches {launches}, "
                             f"expected K2 x {n_attn}")
    if logits.shape != (PREFILL_B, cfg.vocab) or \
            not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"{arch} prefill: logits "
                             f"{tuple(logits.shape)} or non-finite")
    enc_kv = caches[1] if encdec else None
    del caches
    with route_rec() as plain_routes:
        chunked, _ = make_prefill_step(cfg.replace(attn_impl="chunked"),
                                       device=dev)(params, batch)
    spread = {"logits_vs_chunked": sb.rel_l2(logits, chunked)}
    if moe:
        spread["expert_mismatches"] = route_mismatches(routes, plain_routes)
    del chunked, routes, plain_routes
    prefill_ms = bench.event_ms(lambda: prefill(params, batch), flush,
                                runs=5)
    print(f"{arch} prefill B={PREFILL_B} S={S}"
          + (f" + {cfg.encdec.enc_seq} encoder frames" if encdec else "")
          + (f" ({VLM_IMAGE}x{VLM_IMAGE}-patch image, then text, M-RoPE)"
             if cfg.mrope_sections else "")
          + f": launches {launches}  every K2 call vs plain (max abs, rel "
          f"L2): bf16 {k2_call} f32 {k2_call32}  float32 logits vs chunked "
          f"{check32}"
          + (f"  float32 expert choices differing from chunked: "
             f"{mismatch32} of {layers * PREFILL_B * S} token-layers"
             if moe else "")
          + (f"  float32 decode over the encoder K/V vs prefill {dec32}"
             if encdec else "")
          + f"  bf16 {spread}  prefill_ms={prefill_ms:.3f}  "
          f"tokens/s={PREFILL_B * S / prefill_ms * 1e3:.0f}  card: {smi}",
          flush=True)

    # decode: B=4, 16-token prompts, 16 steps.  greedy_decode as the
    # reference's (whisper over zeroed cross caches), every call checked
    prompt = torch.randint(0, cfg.vocab, (DECODE_B, DECODE_PROMPT),
                           generator=gen, device=dev)
    n_steps = DECODE_PROMPT + DECODE_STEPS - 1
    max_seq = WHISPER_TEXT if encdec else MAX_SEQ
    expect = {"K2": layers * n_steps if encdec else 0,
              "K3": layers * n_steps, "K4": 0}
    seen = []
    with contextlib.ExitStack() as stack:
        calls = kernel_checks(stack)
        zero_launch_counts()
        out = greedy_decode(params, cfg, prompt, DECODE_STEPS, max_seq,
                            cache_dtype=dt, device=dev, on_logits=seen.append)
        torch.cuda.synchronize()
        dlaunches = launch_counts()
        k3_call, dk2_groups = worst(calls["K3"]), by_signature(calls["K2"])
        del calls
    if dlaunches != expect:
        raise AssertionError(f"{arch} greedy decode: launches {dlaunches}, "
                             f"expected {expect}")
    if out.shape != (DECODE_B, DECODE_STEPS) or \
            not bool(((out >= 0) & (out < cfg.vocab)).all()) or \
            not all(bool(torch.isfinite(x).all()) for x in seen):
        raise AssertionError(f"{arch} decode: tokens {tuple(out.shape)} out "
                             f"of range, or non-finite logits")
    feed = torch.cat([prompt, out[:, :-1]], dim=1)
    ref_cfg = cfg.replace(attn_impl="reference")

    def run(step_cfg, caches, on_logits=lambda logits: None):
        """The decode steps over ``caches`` along ``feed``'s tokens;
        returns the lengths after the last."""
        step = make_decode_step(step_cfg, device=dev)
        lengths = torch.zeros((DECODE_B,), dtype=torch.int32, device=dev)
        for t in range(n_steps):
            lengths = lengths + 1
            on_logits(step(params, feed[:, t], caches, lengths))
        return lengths

    def new_caches(step_cfg):
        """Decode caches; whisper's cross caches hold the bf16 prefill's
        encoder K/V (its first DECODE_B sequences)."""
        caches = init_caches(step_cfg, DECODE_B, max_seq, cache_dtype=dt,
                             device=dev)
        if encdec:
            caches["cross_k"].copy_(enc_kv[0][:, :DECODE_B])
            caches["cross_v"].copy_(enc_kv[1][:, :DECODE_B])
        return caches

    def vs_plain(got: list, caches) -> float:
        """The largest relative L2 distance of ``got``'s per-step logits
        from the plain path's (reference attention) on the same tokens."""
        want = []
        run(ref_cfg, caches, want.append)
        return max(sb.rel_l2(g, w) for g, w in zip(got, want))

    zero_cross = init_caches(ref_cfg, DECODE_B, max_seq, cache_dtype=dt,
                             device=dev)
    greedy_vs_ref = vs_plain(seen, zero_cross)
    del zero_cross
    if encdec:
        # whisper's serving path: decode steps over caches whose cross
        # caches hold the prefill's encoder K/V, every call checked
        seen, caches = [], new_caches(cfg)
        with contextlib.ExitStack() as stack:
            calls = kernel_checks(stack)
            zero_launch_counts()
            lengths = run(cfg, caches, seen.append)
            torch.cuda.synchronize()
            dlaunches = launch_counts()
            k3_call = worst(calls["K3"])
            dk2_call, dk2_groups = worst(calls["K2"]), by_signature(
                calls["K2"])
            del calls
        if dlaunches != expect:
            raise AssertionError(f"{arch} decode over the encoder K/V: "
                                 f"launches {dlaunches}, expected {expect}")
        if not all(bool(torch.isfinite(x).all()) for x in seen):
            raise AssertionError(f"{arch} decode: non-finite logits")
        decode_vs_ref = vs_plain(seen, new_caches(ref_cfg))
        del enc_kv
    else:
        caches = new_caches(cfg)
        lengths = run(cfg, caches)
        decode_vs_ref = greedy_vs_ref
    # a steady decode step: the kernel path's caches at the prompt's end
    step_ms = bench.event_ms(
        lambda: decode_step(params, feed[:, -1], caches, lengths, cfg),
        flush, runs=20)
    print(f"{arch} decode B={DECODE_B} prompt={DECODE_PROMPT} "
          f"steps={DECODE_STEPS} bf16 caches of {max_seq}"
          + (" (greedy_decode over zeroed cross caches, as the reference's; "
             "then make_decode_step over cross caches holding the "
             "prefill's encoder K/V)" if encdec else "")
          + f": launches {dlaunches}  every K3 call vs plain {k3_call}"
          + (f"  every K2 call (one query row) vs plain "
             f"{dk2_call}" if encdec else "")
          + f"  per-step logits rel L2 vs reference attention: greedy "
          f"{greedy_vs_ref:.3e}"
          + (f", over the encoder K/V {decode_vs_ref:.3e}" if encdec else "")
          + f"  step_ms={step_ms:.3f} at length {int(lengths[0])}  "
          f"tokens/s={DECODE_B / step_ms * 1e3:.0f}  card: {smi}",
          flush=True)
    profile(arch, (
        ("prefill", lambda: prefill(params, batch), 1, prefill_ms),
        ("decode step", lambda: decode_step(params, feed[:, -1], caches,
                                            lengths, cfg), 5, step_ms)))
    del caches

    # K2 alone at each shape of the driven runs, on its first call's
    # inputs; K3 alone over a full cache of the path's length
    entries = []
    for part, groups, ms in (("prefill", k2_groups, prefill_ms),
                             ("decode step", dk2_groups if encdec else [],
                              step_ms)):
        for (q, k, v), kw, n, (err, rel) in groups:
            B, Sq, H, D = q.shape
            Skv, KVH = k.shape[1], k.shape[2]
            role = ("self" if kw["causal"] else
                    "encoder" if part == "prefill" and encdec and Sq == Skv
                    else "cross")
            # calls in one prefill, or in one decode step
            per = n if part == "prefill" else n // n_steps
            e2 = k2_alone(q, k, v, f"{arch} {part} {role}", flush, rate, smi,
                          calls=per, prefill_ms=ms, causal=kw["causal"],
                          part=part)
            entries.append({
                "name": f"flash_attention[{arch} {part} {role} B={B} "
                        f"Sq={Sq} Skv={Skv} H={H} KVH={KVH} D={D} "
                        f"{'causal' if kw['causal'] else 'non-causal'} "
                        f"bf16]",
                "launches": n, **e2, "max_abs_err": err, "rel_l2_err": rel,
                f"{part.replace(' ', '_')}_ms": ms})
        del groups
    del k2_groups, dk2_groups
    H, KVH, D = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    e3 = k3_alone(DECODE_B, H, KVH, D, dt, gen, arch, flush, rate, smi,
                  max_seq=max_seq)
    entries.append({
        "name": f"flash_decode[{arch} B={DECODE_B} S={max_seq} H={H} "
                f"KVH={KVH} D={D} bf16 cache]",
        "launches": dlaunches["K3"], **e3, "max_abs_err": k3_call[0],
        "rel_l2_err": k3_call[1], "decode_step_ms": step_ms})
    if encdec:
        # the decode cross attention's function as K3 would run it, over
        # the whole encoder cache; printed beside K2's one query row
        k3_alone(DECODE_B, H, KVH, D, dt, gen,
                 f"{arch} cross attention as a decode over the encoder K/V",
                 flush, rate, smi, max_seq=cfg.encdec.enc_seq)
    return entries


def tree_to(tree, dev):
    from repro_torch.tree import tree_map

    return tree_map(lambda t: t.to(dev), tree)


def train_batch(cfg, B: int, S: int, step: int, dev, gen=None) -> dict:
    """``SyntheticTokens``' batch ``step`` on ``dev`` (and, for encdec,
    stub frame embeddings from ``gen`` on the CPU)."""
    from repro_torch.data.pipeline import DataCfg, SyntheticTokens

    batch = {k: torch.from_numpy(v) for k, v in
             SyntheticTokens(DataCfg(cfg.vocab, S, B)).batch(step).items()}
    if cfg.family == "encdec":
        batch["enc_frames"] = torch.randn(
            (B, cfg.encdec.enc_seq, cfg.d_model), generator=gen)
    return {k: v.to(dev) for k, v in batch.items()}


def train_card_vs_cpu(dev) -> None:
    """10a. A smoke-width float32 train step of every family on the card
    and on the CPU from the same state, gated at ``TRAIN_STEP_TOL``."""
    from repro_torch.configs import ARCHS, smoke
    from repro_torch.launch.train import make_step
    from repro_torch.models import init_params
    from repro_torch.optim.adamw import init_opt_state
    from repro_torch.tree import tree_leaves

    for family, arch in TRAIN_FAMILIES:
        cfg = smoke(ARCHS[arch]).replace(attn_impl="chunked", remat="full")
        gen = torch.Generator().manual_seed(0)
        step = make_step(cfg, steps=TRAIN_STEPS)
        params = init_params(gen, cfg, device="cpu")
        opt = init_opt_state(params)
        b1 = train_batch(cfg, TRAIN_FAMILY_B, TRAIN_FAMILY_S, 0, "cpu", gen)
        b2 = train_batch(cfg, TRAIN_FAMILY_B, TRAIN_FAMILY_S, 1, "cpu", gen)
        # step 1 on both; step 2 from the CPU's state after step 1 (a
        # first AdamW step moves every parameter by about lr, whatever
        # its gradient: the second also tests the gradients' size)
        p1, o1, m1 = step(params, opt, b1)
        _, _, c1 = step(tree_to(params, dev), tree_to(opt, dev),
                        tree_to(b1, dev))
        p2, _, m2 = step(p1, o1, b2)
        q2, _, c2 = step(tree_to(p1, dev), tree_to(o1, dev),
                         tree_to(b2, dev))
        for want, got in ((m1, c1), (m2, c2)):
            w, g = float(want["loss"]), float(got["loss"])
            if not abs(g - w) <= TRAIN_LOSS_RTOL * abs(w):
                raise AssertionError(f"train {arch}: card loss {g} vs CPU "
                                     f"{w} past rtol {TRAIN_LOSS_RTOL}")
        worst = max(close(got.cpu(), want, f"train {arch} param {i}",
                          **TRAIN_STEP_TOL)
                    for i, (want, got) in enumerate(zip(tree_leaves(p2),
                                                        tree_leaves(q2))))
        print(f"train card vs CPU {family:6s} {arch:22s} smoke float32, "
              f"B={TRAIN_FAMILY_B} S={TRAIN_FAMILY_S}: loss (CPU / card) "
              f"{float(m1['loss']):.7f} / {float(c1['loss']):.7f}, step 2 "
              f"{float(m2['loss']):.7f} / {float(c2['loss']):.7f}; "
              f"grad_norm step 2 {float(m2['grad_norm']):.6e} / "
              f"{float(c2['grad_norm']):.6e}; params after step 2 max abs "
              f"err {worst:.3e}", flush=True)


def gradient_probe(cfg, params: dict, batch: dict, dev) -> str:
    """The gradient's norm at each of ``PROBE_DEPTHS`` layers and at
    full depth, and its relative change under a ``PROBE_EPS``
    perturbation of every weight (float32, one sequence)."""
    from repro_torch.optim.adamw import global_norm
    from repro_torch.train.step import value_and_grad
    from repro_torch.tree import tree_map

    cfg = cfg.replace(dtype="float32")
    one = {k: v[:1] for k, v in batch.items()}
    gen = torch.Generator(device=dev).manual_seed(2)
    out = []
    for depth in sorted({min(d, cfg.n_layers) for d in PROBE_DEPTHS}
                        | {cfg.n_layers}):
        cut = dict(params, blocks=params["blocks"][:depth])
        ccfg = cfg.replace(n_layers=depth)
        g0 = value_and_grad(cut, one, ccfg)[1]
        moved = tree_map(lambda p: p * (1 + PROBE_EPS * torch.randn(
            p.shape, generator=gen, device=p.device)), cut)
        g1 = value_and_grad(moved, one, ccfg)[1]
        norm = float(global_norm(g0))
        change = float(global_norm(tree_map(torch.sub, g1, g0))) / norm
        if not (math.isfinite(norm) and math.isfinite(change)):
            raise AssertionError(f"gradient probe {cfg.name} at {depth} "
                                 f"layers: norm {norm}, change {change}")
        out.append(f"{depth} layers: grad_norm {norm:.6g}, change "
                   f"{change:.3e}")
        del g0, g1, moved
    torch.cuda.empty_cache()
    return "; ".join(out)


def train_full_width(arch: str, dev, smi: str):
    """10b/10c. ``TRAIN_STEPS`` steps of ``train_loop``'s step function
    at full width: float32 masters, bf16 compute, ``remat="full"``,
    ``attn_impl="chunked"``; the first step's loss also with two
    microbatches; each step's loss, gradient norm, learning rate, clip
    scale and update size printed.  Gates: the losses finite, every
    step's update at least ``UPDATE_FLOOR`` times its learning rate, the
    first batch's loss after the last step below its loss before the
    first, and for ``LAST_BELOW_FIRST`` the last step's loss below the
    first's.  Returns the masters after the last step."""
    from repro_torch.configs import ARCHS
    from repro_torch.launch.train import make_step
    from repro_torch.models import init_params
    from repro_torch.optim.adamw import AdamWCfg, init_opt_state
    from repro_torch.train.step import loss_fn
    from repro_torch.tree import tree_leaves

    cfg = ARCHS[arch].replace(remat="full", attn_impl="chunked")
    B, S = TRAIN_B, TRAIN_S
    params = init_params(torch.Generator(device=dev).manual_seed(0), cfg,
                         device=dev)
    opt = init_opt_state(params)
    n_params = sum(p.numel() for p in tree_leaves(params))
    step = make_step(cfg, steps=TRAIN_STEPS)
    batches = [train_batch(cfg, B, S, s, dev) for s in range(TRAIN_STEPS)]
    probe = gradient_probe(cfg, params, batches[0], dev)
    print(f"train {arch} gradient probe before training (float32, 1 x "
          f"{S} tokens, weights scaled by 1 + {PROBE_EPS:g} N(0, 1)): "
          f"{probe}", flush=True)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    with torch.no_grad():
        before = float(loss_fn(params, batches[0], cfg)[0])
    _, _, mb = make_step(cfg, steps=TRAIN_STEPS, microbatches=2)(
        params, opt, batches[0])
    mb_loss = float(mb["loss"])
    clip = AdamWCfg().clip_norm
    losses, ms, lines, updates = [], [], [], []
    for s in range(TRAIN_STEPS):
        t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        old = params
        t0.record()
        params, opt, metrics = step(params, opt, batches[s])
        t1.record()
        losses.append(float(metrics["loss"]))  # synchronises
        ms.append(t0.elapsed_time(t1))
        with torch.no_grad():
            rms = float(torch.sqrt(sum(
                torch.sum(torch.square(a - b)) for a, b in
                zip(tree_leaves(params), tree_leaves(old))) / n_params))
        lr, gnorm = float(metrics["lr"]), float(metrics["grad_norm"])
        updates.append(rms / lr)
        lines.append(f"  step {s}: loss {losses[-1]:.6f} grad_norm "
                     f"{gnorm:.6g} lr {lr:.4e} clip scale "
                     f"{min(1.0, clip / gnorm):.4e} update rms {rms:.4e} "
                     f"= {rms / lr:.3f} x lr")
    del old
    peak = torch.cuda.max_memory_allocated(dev)
    with torch.no_grad():
        after = float(loss_fn(params, batches[0], cfg)[0])
    print(f"train {arch} steps:\n" + "\n".join(lines), flush=True)
    if not all(math.isfinite(v) for v in losses + [before, after]):
        raise AssertionError(f"train {arch}: losses {losses}, the first "
                             f"batch's before {before}, after {after}")
    if min(updates) < UPDATE_FLOOR:
        raise AssertionError(f"train {arch}: a step moved the parameters "
                             f"by less than {UPDATE_FLOOR} x lr: "
                             f"{updates}")
    if not after < before:
        raise AssertionError(f"train {arch}: the first batch's loss "
                             f"{before} before the first step, {after} "
                             f"after the last")
    if arch in LAST_BELOW_FIRST and not losses[-1] < losses[0]:
        raise AssertionError(f"train {arch}: last loss {losses[-1]} not "
                             f"below the first {losses[0]}")
    if not abs(mb_loss - losses[0]) <= TRAIN_MB_RTOL * abs(losses[0]):
        raise AssertionError(f"train {arch}: first loss {losses[0]} with "
                             f"one microbatch, {mb_loss} with two")
    step_ms = statistics.median(ms)
    tokens = B * S
    flops = 6 * n_params * tokens
    if cfg.family != "ssm":
        flops += 12 * B * S * S * cfg.n_heads * cfg.hd * cfg.n_layers
    print(f"train {arch} full width ({cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, vocab {cfg.vocab}, {n_params} parameters): "
          f"float32 masters, bf16 compute, remat=full, chunked, B={B} "
          f"S={S}, {TRAIN_STEPS} steps: step_ms={step_ms:.1f} (steps "
          + ", ".join(f"{t:.1f}" for t in ms)
          + f")  tokens/s={tokens / step_ms * 1e3:.0f}  peak memory "
          f"{peak / 2**30:.2f} GiB  loss first {losses[0]:.6f} last "
          f"{losses[-1]:.6f}  first batch before the first step "
          f"{before:.6f}, after the last {after:.6f}  two microbatches: "
          f"first loss {mb_loss:.6f}  model "
          f"{flops / 1e12:.2f} TFLOP a step = "
          f"{100 * flops / (step_ms * 1e-3) / BF16_PEAK:.1f} % of 989 "
          f"TFLOP/s  card: {smi}", flush=True)
    profile(f"train {arch}", (("step", lambda: step(params, opt,
                                                    batches[0]), 1,
                               step_ms),))
    return params


def train_resume(dev) -> None:
    """10d. Exact resume on the card: qwen3-0.6b's full width cut to
    ``RESUME_LAYERS`` layers, 5 straight steps against 3 steps, a crash
    and 2 resumed steps."""
    import shutil

    from repro_torch.configs import ARCHS
    from repro_torch.launch.train import train_loop
    from repro_torch.tree import tree_leaves

    cfg = ARCHS[LM_ARCH].replace(n_layers=RESUME_LAYERS, remat="full",
                                 attn_impl="chunked")
    root = ROOT / "build" / "repro_torch" / "phase10_ckpt"
    shutil.rmtree(root, ignore_errors=True)
    kw = dict(steps=5, batch=TRAIN_B, seq=RESUME_S, device=dev, log_every=5)
    try:
        t0 = time.perf_counter()
        pa, oa, la = train_loop(cfg, ckpt_dir=str(root / "a"),
                                ckpt_every=100, **kw)
        train_loop(cfg, ckpt_dir=str(root / "b"), ckpt_every=3,
                   stop_after=3, **kw)
        pb, ob, lb = train_loop(cfg, ckpt_dir=str(root / "b"), resume=True,
                                ckpt_every=100, **kw)
        wall = time.perf_counter() - t0
    finally:
        shutil.rmtree(root, ignore_errors=True)
    leaves = list(zip(tree_leaves((pa, oa)), tree_leaves((pb, ob))))
    worst = max(close(b, a, f"resume leaf {i}", 1e-6, 1e-6)
                for i, (a, b) in enumerate(leaves))
    same = sum(bool(torch.equal(a, b)) for a, b in leaves)
    print(f"train resume {LM_ARCH} full width cut to {RESUME_LAYERS} "
          f"layers, B={TRAIN_B} S={RESUME_S}: 5 straight steps vs 3 + "
          f"crash + 2 resumed: losses {la[3:]} vs {lb}, {len(leaves)} "
          f"leaves (params, m, v, step) max abs err {worst:.3e}, {same} "
          f"bit for bit; three runs with checkpoints in {wall:.1f} s",
          flush=True)


def serve_trained(masters: dict, dev, smi: str) -> None:
    """10e. The trained qwen3-0.6b masters (leaves that require grad, as
    an optimizer's are) cast to bf16 and served through K2 and K3, every
    kernel call held against its plain version on its own inputs."""
    from repro_torch.configs import ARCHS
    from repro_torch.models.lm import cast
    from repro_torch.serve import greedy_decode, make_prefill_step
    from repro_torch.tree import tree_map

    cfg = ARCHS[LM_ARCH].replace(attn_impl="pallas")
    masters = tree_map(lambda p: p.requires_grad_(), masters)
    params = cast(masters, torch.bfloat16)
    gen = torch.Generator(device=dev).manual_seed(1)
    tokens = torch.randint(0, cfg.vocab, (PREFILL_B, PREFILL_S),
                           generator=gen, device=dev)
    with contextlib.ExitStack() as stack:
        calls = kernel_checks(stack)
        zero_launch_counts()
        logits, caches = make_prefill_step(cfg, device=dev)(
            params, {"tokens": tokens})
        torch.cuda.synchronize()
        counts = launch_counts()
        k2_call = worst(calls["K2"])
        del calls
    if counts != {"K2": cfg.n_layers, "K3": 0, "K4": 0}:
        raise AssertionError(f"trained prefill launches {counts}")
    del caches
    want, _ = make_prefill_step(cfg.replace(attn_impl="chunked"),
                                device=dev)(params, {"tokens": tokens})
    check = lm_check(logits, want, "trained prefill vs chunked",
                     **LM_TOL["bfloat16"])
    prompt = tokens[:, :DECODE_PROMPT]
    with contextlib.ExitStack() as stack:
        calls = kernel_checks(stack)
        zero_launch_counts()
        out = greedy_decode(params, cfg, prompt, TRAIN_DECODE_STEPS,
                            MAX_SEQ, cache_dtype=torch.bfloat16,
                            device=dev)
        torch.cuda.synchronize()
        counts = launch_counts()
        k3_call = worst(calls["K3"])
        del calls
    n_steps = DECODE_PROMPT + TRAIN_DECODE_STEPS - 1
    if counts != {"K2": 0, "K3": cfg.n_layers * n_steps, "K4": 0}:
        raise AssertionError(f"trained decode launches {counts}")
    if out.shape != (PREFILL_B, TRAIN_DECODE_STEPS) or \
            not bool(((out >= 0) & (out < cfg.vocab)).all()):
        raise AssertionError(f"trained decode: tokens {tuple(out.shape)}")
    print(f"train -> serve {LM_ARCH}: trained masters in bf16 with "
          f"attn_impl=pallas: prefill B={PREFILL_B} S={PREFILL_S} K2 "
          f"launches={cfg.n_layers}, each against its plain version: max "
          f"abs err {k2_call[0]:.3e}, rel l2 {k2_call[1]:.3e}; logits vs "
          f"chunked {check} (largest |logit| {float(want.abs().max()):.2f});"
          f" greedy decode {TRAIN_DECODE_STEPS} steps from {DECODE_PROMPT}"
          f"-token prompts: K3 launches={counts['K3']} ({cfg.n_layers} a "
          f"step), each against its plain version: max abs err "
          f"{k3_call[0]:.3e}, rel l2 {k3_call[1]:.3e}  card: {smi}",
          flush=True)


def train_guard(dev) -> None:
    """10f. A train step through the forward-only kernels raises."""
    from repro_torch.configs import ARCHS, smoke
    from repro_torch.launch.train import make_step
    from repro_torch.models import init_params
    from repro_torch.optim.adamw import init_opt_state

    cfg = smoke(ARCHS[LM_ARCH]).replace(attn_impl="pallas")
    params = init_params(torch.Generator(device=dev).manual_seed(0), cfg,
                         device=dev)
    batch = train_batch(cfg, 2, 64, 0, dev)
    zero_launch_counts()
    try:
        make_step(cfg, steps=1)(params, init_opt_state(params), batch)
    except RuntimeError as e:
        if 'attn_impl="chunked"' not in str(e):
            raise
        message = str(e)
    else:
        raise AssertionError("a train step with attn_impl='pallas' ran")
    if launch_counts()["K2"]:
        raise AssertionError("the refused train step launched K2")
    print(f"train guard: a train step with attn_impl=pallas on the card "
          f"raises RuntimeError: {message}", flush=True)


def full(t):
    """A DTensor's whole value; any other tensor as it is."""
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def event_median(fn, n: int) -> float:
    """Median CUDA-event time (ms) of ``n`` calls of ``fn``, the host's
    launches inside."""
    ms = []
    for _ in range(n):
        t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0.record()
        fn()
        t1.record()
        torch.cuda.synchronize()
        ms.append(t0.elapsed_time(t1))
    return statistics.median(ms)


def mesh_train(mesh, dev, smi: str) -> tuple:
    """11a. Phase 10b's first step (qwen3-0.6b at full width and depth,
    the same seeded masters and batch 0) unsharded and sharded over
    ``mesh`` by ``param_specs`` under ``use_mesh``: loss and every
    parameter at the reference's tolerances; both timed.  Returns the
    masters, the step, its batch and the unsharded ``step_ms``."""
    from repro_torch.configs import ARCHS
    from repro_torch.distributed.ctx import use_mesh
    from repro_torch.distributed.sharding import distribute, param_specs
    from repro_torch.launch.specs import batch_specs
    from repro_torch.launch.train import make_step
    from repro_torch.models import init_params
    from repro_torch.optim.adamw import init_opt_state
    from repro_torch.tree import tree_leaves

    cfg = ARCHS[LM_ARCH].replace(remat="full", attn_impl="chunked")
    params = init_params(torch.Generator(device=dev).manual_seed(0), cfg,
                         device=dev)
    opt = init_opt_state(params)
    batch = train_batch(cfg, TRAIN_B, TRAIN_S, 0, dev)
    step = make_step(cfg, steps=TRAIN_STEPS)
    new, _, metrics = step(params, opt, batch)
    want_loss = float(metrics["loss"])
    want = [t.cpu() for t in tree_leaves(new)]
    del new, metrics
    plain_ms = event_median(lambda: step(params, opt, batch), MESH_STEPS)
    with use_mesh(mesh):
        specs = param_specs(params, mesh)
        placed = (distribute(params, specs, mesh),
                  {"m": distribute(opt["m"], specs, mesh),
                   "v": distribute(opt["v"], specs, mesh),
                   "step": opt["step"]},
                  distribute(batch, batch_specs(batch, mesh), mesh))
        new, _, metrics = step(*placed)
        got_loss = float(full(metrics["loss"]))
        got = [full(t) for t in tree_leaves(new)]
        del new, metrics
        mesh_ms = event_median(lambda: step(*placed), MESH_STEPS)
    if not abs(got_loss - want_loss) <= MESH_LOSS_RTOL * abs(want_loss):
        raise AssertionError(f"mesh train: loss {got_loss} sharded, "
                             f"{want_loss} unsharded")
    worst = max(close(g, w.to(dev), f"mesh train leaf {i}",
                      **MESH_PARAM_TOL)
                for i, (g, w) in enumerate(zip(got, want)))
    kinds = sorted({str(p) for t in tree_leaves(placed[0])
                    for p in t.placements})
    print(f"mesh train {LM_ARCH} full width ({cfg.n_layers} layers), "
          f"B={TRAIN_B} S={TRAIN_S}, (1, 1) mesh over NCCL, params laid "
          f"out by param_specs ({', '.join(kinds)}): loss {got_loss:.6f} "
          f"sharded, {want_loss:.6f} unsharded; {len(got)} parameters "
          f"after the step, max abs err {worst:.3e} (gate atol="
          f"{MESH_PARAM_TOL['atol']} rtol={MESH_PARAM_TOL['rtol']})  "
          f"step_ms={mesh_ms:.1f} sharded, {plain_ms:.1f} unsharded "
          f"(median of {MESH_STEPS}, CUDA events)  card: {smi}", flush=True)
    return cfg, params, opt, step, batch, plain_ms


def mesh_serve(mesh, masters: dict, dev, smi: str) -> None:
    """11b. qwen3-0.6b's prefill and decode through ``specs.build_cell``
    on ``mesh`` (default ``attn_impl``, as the reference's cells), bf16,
    against the unsharded ``make_prefill_step`` and ``make_decode_step``
    at the bf16 logit gate; the decode's new cache rows must be the
    unsharded step's bit for bit (one rank runs the unsharded ops)."""
    from repro_torch.configs import ARCHS
    from repro_torch.launch.specs import build_cell
    from repro_torch.models import init_caches
    from repro_torch.models.lm import cast
    from repro_torch.serve.engine import make_decode_step, make_prefill_step

    cfg = ARCHS[LM_ARCH]
    params = cast(masters, torch.bfloat16)
    gen = torch.Generator().manual_seed(11)
    B, S, max_seq = 4, 2048, 4096
    batch = {"tokens": torch.randint(0, cfg.vocab, (B, S),
                                     generator=gen).to(dev)}
    cell = build_cell(LM_ARCH, "prefill_32k", mesh, cfg_override=cfg,
                      device=dev)
    placed = cell.place(params, batch)
    logits, caches = cell.run(*placed)
    plain = make_prefill_step(cfg, device=dev)
    want, (k, v) = plain(params, batch)
    pre = lm_check(full(logits), want, "mesh prefill", **LM_TOL["bfloat16"])
    pre_ms = event_median(lambda: cell.run(*placed), 3)
    plain_pre_ms = event_median(lambda: plain(params, batch), 3)

    def filled():
        c = init_caches(cfg, B, max_seq, device=dev)
        c["k"][:, :, :S], c["v"][:, :, :S] = k, v
        return c

    token = want.argmax(-1).to(torch.int32)
    lengths = torch.full((B,), S + 1, dtype=torch.int32, device=dev)
    dcell = build_cell(LM_ARCH, "decode_32k", mesh, cfg_override=cfg,
                       device=dev)
    dplaced = dcell.place(params, token, filled(), lengths)
    got = full(dcell.run(*dplaced))
    plain_caches = filled()
    dwant = make_decode_step(cfg, device=dev)(params, token, plain_caches,
                                              lengths)
    dec = lm_check(got, dwant, "mesh decode", **LM_TOL["bfloat16"])
    for name in ("k", "v"):
        row = full(dplaced[2][name])[:, :, S]
        if not torch.equal(row, plain_caches[name][:, :, S]):
            err = (row.float() - plain_caches[name][:, :, S].float()).abs()
            raise AssertionError(f"mesh decode cache {name}: the new row "
                                 f"differs from the unsharded step's, max "
                                 f"abs err {err.max().item():.3e}")
    print(f"mesh serve {LM_ARCH} bf16 through build_cell on the (1, 1) "
          f"mesh ({cfg.attn_impl}): prefill B={B} S={S} rel L2 "
          f"{pre['rel_l2']:.3e} max abs {pre['max_abs_err']:.3e} against "
          f"make_prefill_step, prefill_ms={pre_ms:.1f} sharded, "
          f"{plain_pre_ms:.1f} unsharded (median of 3); decode at length "
          f"{S + 1} of {max_seq} rel L2 {dec['rel_l2']:.3e} max abs "
          f"{dec['max_abs_err']:.3e} against make_decode_step, the new "
          f"K/V rows bit for bit (torch.equal)  card: {smi}", flush=True)


def mesh_roofline(cfg, params, opt, step, batch, step_ms: float,
                  smi: str) -> None:
    """11c. The unsharded step of 11a counted: FLOPs by
    ``FlopCounterMode``, bytes accessed (and the same FLOPs again) by the
    dry run's counter, through ``Roofline`` with the H100 constants,
    beside the measured ``step_ms``."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.configs import ShapeCfg
    from repro_torch.launch.dryrun import CostCounter
    from repro_torch.roofline.analysis import (HBM_BW, PEAK_FLOPS, Roofline,
                                               model_flops_for)

    with FlopCounterMode(display=False) as fc:
        step(params, opt, batch)
    flops = fc.get_total_flops()
    with CostCounter() as cc:
        step(params, opt, batch)
    if abs(cc.flops - flops) > 1e-9 * flops:
        raise AssertionError(f"mesh roofline: FlopCounterMode counted "
                             f"{flops} FLOPs, the dry run's counter "
                             f"{cc.flops}")
    shape = ShapeCfg("train", TRAIN_S, TRAIN_B, "train")
    roof = Roofline(arch=LM_ARCH, shape=f"train B={TRAIN_B} S={TRAIN_S}",
                    mesh="1x1", n_chips=1, flops_per_device=flops,
                    bytes_per_device=cc.bytes, coll_bytes_per_device=0.0,
                    model_flops=model_flops_for(cfg, shape))
    print(f"mesh roofline {LM_ARCH} train step (B={TRAIN_B} S={TRAIN_S}, "
          f"bf16 compute, remat=full, chunked): counted {flops:.4e} FLOPs "
          f"(matrix products, recompute and backward included), "
          f"{cc.bytes:.4e} bytes accessed (every op's inputs and outputs), "
          f"model FLOPs {roof.model_flops:.4e}; at {PEAK_FLOPS:.3e} FLOP/s "
          f"and {HBM_BW:.3e} B/s: t_compute={roof.t_compute * 1e3:.3f} ms "
          f"t_memory={roof.t_memory * 1e3:.3f} ms bottleneck="
          f"{roof.bottleneck} roofline_fraction={roof.roofline_fraction:.4f}"
          f"  measured step_ms={step_ms:.1f}  card: {smi}", flush=True)


def mesh_dryrun() -> None:
    """11d. The dry run's gate cell, host-only, in a subprocess."""
    import os
    import subprocess

    arch, shape = DRYRUN_CELL
    out = ROOT / "build" / "repro_torch" / "dryrun"
    t0 = time.perf_counter()
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
         "--shape", shape, "--out", str(out)],
        env={**os.environ, "PYTHONPATH": str(ROOT / "src"),
             "CUDA_VISIBLE_DEVICES": ""},
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    if "dry-run complete: 1 ok" not in r.stdout:
        raise AssertionError(f"dry run: {r.stdout[-2000:]}"
                             f"{r.stderr[-3000:]}")
    rec = json.loads((out / f"{arch}__{shape}__16x16.json").read_text())
    print(f"mesh dryrun {arch} x {shape} on the 16x16 mesh ({rec['n_chips']}"
          f" fake ranks, meta tensors): status {rec['status']}  "
          f"flops_per_device={rec['flops_per_device']:.4e} "
          f"bytes_per_device={rec['bytes_per_device']:.4e} "
          f"coll_bytes_per_device={rec['coll_bytes_per_device']:.4e} "
          f"bottleneck={rec['bottleneck']} memory (estimate) "
          f"{rec['memory_stats']}  {time.perf_counter() - t0:.1f} s",
          flush=True)


def mesh_phase(dev, smi: str) -> None:
    """Phase 11: the mesh on the card, a (1, 1) mesh over a one-rank
    NCCL group on 127.0.0.1."""
    import socket

    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh

    t0 = time.perf_counter()
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                            rank=0, world_size=1, device_id=dev)
    try:
        mesh = make_host_mesh(dev)
        cfg, params, opt, step, batch, step_ms = mesh_train(mesh, dev, smi)
        torch.cuda.empty_cache()
        mesh_serve(mesh, params, dev, smi)
        torch.cuda.empty_cache()
        mesh_roofline(cfg, params, opt, step, batch, step_ms, smi)
        del params, opt, batch
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    mesh_dryrun()
    print(f"mesh phase: {time.perf_counter() - t0:.1f} s", flush=True)


def train_phase(dev, smi: str) -> None:
    """Phase 10: training on the card."""
    t0 = time.perf_counter()
    train_card_vs_cpu(dev)
    masters = train_full_width(LM_ARCH, dev, smi)
    torch.cuda.empty_cache()
    train_full_width("mamba2-130m", dev, smi)
    torch.cuda.empty_cache()
    train_resume(dev)
    serve_trained(masters, dev, smi)
    del masters
    torch.cuda.empty_cache()
    train_guard(dev)
    print(f"training phase: {time.perf_counter() - t0:.1f} s", flush=True)


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

    # 8b. the moe, encdec and vlm paths at full width
    t0 = time.perf_counter()
    for arch, layers in FAMILY_PATHS:
        entries += serve_family(arch, layers, dev, flush, rate, smi)
        torch.cuda.empty_cache()
    print(f"moe, encdec and vlm paths: {time.perf_counter() - t0:.1f} s",
          flush=True)

    # 10. training on the card, then the trained weights through K2, K3
    train_phase(dev, smi)

    # 11. the mesh on the card: sharded step, serving cells, roofline,
    # dry run
    mesh_phase(dev, smi)

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
