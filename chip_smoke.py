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
   cache, beside their plain versions, their bounds and one
   ``scaled_dot_product_attention`` call as a yardstick;
7. the ``kernels`` line: for each kernel and main path, its launches in
   one driven run (counts set to zero just before it), its error
   against the plain version, its times and its bound.

The last line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

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
K1_SOURCE = "src/repro_torch/kernels/stencil2d/csrc/stencil2d.cuh"
K1_REPLACES = "src/repro/kernels/stencil2d/kernel.py:95"
K2_SOURCE = "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu"
K2_REPLACES = "src/repro/kernels/flash_attention/kernel.py:83"
K3_SOURCE = "src/repro_torch/kernels/flash_decode/csrc/flash_decode.cu"
K3_REPLACES = "src/repro/kernels/flash_decode/kernel.py:74"
# K2 and K3 against their plain versions: elementwise, and relative L2
# over the whole output.  Elementwise, float32: the reference's kernel
# tests; bf16: the same float32 arithmetic and one rounding of the output
# to bf16 in each version, at most 2**-7 relative apart, doubled.  The
# relative L2 bound is what catches a wrong tile or split (a dropped one
# of the 16 splits of a 4096-position cache reads about 0.25); it stands
# 13x (bf16) and 40x (float32) above the largest error measured on an
# H100 over all shapes here (PERF.md).
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
LM_ARCH = "qwen3-0.6b"
PREFILL_B, PREFILL_S = 4, 2048
DECODE_B, DECODE_PROMPT, DECODE_STEPS, MAX_SEQ = 4, 16, 16, 4096


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


def attn_close(got, want, tag: str) -> tuple[float, float]:
    """(max abs err, relative L2 err) of an attention output against its
    plain version; raises past ``ATTN_TOL`` of its dtype."""
    from repro_torch.serve import bench as sb

    tol = ATTN_TOL[want.dtype]
    e = close(got, want, tag, tol["atol"], tol["rtol"])
    r = sb.rel_l2(got, want)
    if not r <= tol["rel_l2"]:
        raise AssertionError(f"{tag}: relative L2 err {r:.3e} past "
                             f"{tol['rel_l2']}")
    return e, r


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
    import torch.nn.functional as F

    from repro_torch.configs import ARCHS
    from repro_torch.kernels.flash_attention import kernel as k2
    from repro_torch.kernels.flash_decode import kernel as k3
    from repro_torch.kernels.stencil2d import bench
    from repro_torch.models import decode_step, init_caches, init_params
    from repro_torch.models.lm import cast
    from repro_torch.serve import bench as sb
    from repro_torch.serve import greedy_decode, make_prefill_step

    name = torch.cuda.get_device_name(dev)
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
    k3_step_ms = bench.event_ms(k3_step, flush, runs=20)
    print(f"decode B={DECODE_B} prompt={DECODE_PROMPT} steps={DECODE_STEPS} "
          f"max_seq={MAX_SEQ} bf16 caches: K3 launches={k3_launches} "
          f"(K2 {k2_decode})  per-step logits vs reference {worst}  "
          f"greedy_ms={greedy_ms:.1f} ({n_steps} steps, "
          f"{greedy_ms / n_steps:.3f} ms/step incl. host)  "
          f"step_ms={step_ms:.3f} at length {int(lengths[0])}  "
          f"tokens/s={DECODE_B / step_ms * 1e3:.0f}  "
          f"K3 at that length {k3_step_ms:.4f} ms x {cfg.n_layers} layers = "
          f"{100 * k3_step_ms * cfg.n_layers / step_ms:.1f} % of a step  "
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

    # K2 alone at the prefill shape
    H, KVH, D = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = torch.randn((PREFILL_B, PREFILL_S, H, D), generator=gen,
                    device=dev).to(dt)
    k = torch.randn((PREFILL_B, PREFILL_S, KVH, D), generator=gen,
                    device=dev).to(dt)
    v = torch.randn((PREFILL_B, PREFILL_S, KVH, D), generator=gen,
                    device=dev).to(dt)
    run = dict(causal=True, window=None, q_offset=0, scale=D ** -0.5)
    want = k2.flash_attention_plain(q, k, v, **run)
    k2_err, k2_rel = attn_close(k2.flash_attention_fwd(q, k, v, **run), want,
                                "K2 at the prefill shape")
    # time the launch alone, through the helper the wrapper launches by
    o, k2_run = k2.prepare(q, k, v, **run)
    k2_blocks = k2_run()
    attn_close(o, want, "K2 at the prefill shape, timed launch")
    k2_ms = bench.event_ms(k2_run, flush)
    k2_plain_ms = bench.event_ms(lambda: k2.flash_attention_plain(q, k, v,
                                                                  **run),
                                 flush, runs=5)
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    k2_lib_ms = bench.event_ms(
        lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                               enable_gqa=True), flush)
    flops, nbytes = sb.attention_work(q, k, v, causal=True, window=None,
                                      q_offset=0)
    k2_bound, k2_by = sb.bound_ms(flops, nbytes, sb.bf16_peak(name),
                                  rate)
    print(f"K2 (B={PREFILL_B} S={PREFILL_S} H={H} KVH={KVH} D={D} causal "
          f"bf16): ms={k2_ms:.4f}  plain_ms={k2_plain_ms:.3f}  "
          f"sdpa_ms={k2_lib_ms:.4f}  flops={flops:.3e} bytes={nbytes}  "
          f"bound_ms={k2_bound:.4f} ({k2_by})  "
          f"{flops / k2_ms / 1e9:.1f} TFLOP/s  "
          f"{100 * k2_ms * cfg.n_layers / prefill_ms:.1f} % of prefill  "
          f"blocks={k2_blocks}  max_abs_err={k2_err:.3e}  "
          f"rel_l2_err={k2_rel:.3e}  card: {smi}", flush=True)
    del q, k, v, o, qt, kt, vt, want

    # K3 alone over a full 4096-position bf16 cache
    q = torch.randn((DECODE_B, H, D), generator=gen, device=dev).to(dt)
    kc = torch.randn((DECODE_B, MAX_SEQ, KVH, D), generator=gen,
                     device=dev).to(dt)
    vc = torch.randn((DECODE_B, MAX_SEQ, KVH, D), generator=gen,
                     device=dev).to(dt)
    lengths = torch.full((DECODE_B,), MAX_SEQ, dtype=torch.int32, device=dev)
    want = k3.flash_decode_plain(q, kc, vc, lengths, window=None,
                                 scale=D ** -0.5)
    k3_err, k3_rel = attn_close(k3.flash_decode(q, kc, vc, lengths), want,
                                "K3 at a full cache")
    o, k3_run = k3.prepare(q, kc, vc, lengths, window=None, scale=D ** -0.5)
    k3_blocks = "+".join(map(str, k3_run()))  # split kernel + combine
    attn_close(o, want, "K3 at a full cache, timed launch")
    k3_ms = bench.event_ms(k3_run, flush)
    k3_plain_ms = bench.event_ms(
        lambda: k3.flash_decode_plain(q, kc, vc, lengths, window=None,
                                      scale=D ** -0.5), flush)
    qt = q[:, :, None]
    kt, vt = (t.transpose(1, 2).contiguous() for t in (kc, vc))
    k3_lib_ms = bench.event_ms(
        lambda: F.scaled_dot_product_attention(qt, kt, vt, enable_gqa=True),
        flush)
    flops, nbytes = sb.decode_work(q, kc, vc, lengths, window=None)
    k3_bound, k3_by = sb.bound_ms(flops, nbytes, sb.bf16_peak(name),
                                  rate)
    print(f"K3 (B={DECODE_B} H={H} KVH={KVH} D={D} S=lengths={MAX_SEQ} bf16 "
          f"cache, blocks={k3_blocks} split+combine): "
          f"ms={k3_ms:.4f}  plain_ms={k3_plain_ms:.4f}  "
          f"sdpa_ms={k3_lib_ms:.4f}  bytes={nbytes}  "
          f"bound_ms={k3_bound:.4f} ({k3_by})  "
          f"{nbytes / k3_ms / 1e6:.1f} GB/s  max_abs_err={k3_err:.3e}  "
          f"rel_l2_err={k3_rel:.3e}  card: {smi}", flush=True)

    return [
        {"name": f"flash_attention[{LM_ARCH} prefill B={PREFILL_B} "
                 f"S={PREFILL_S} causal bf16]",
         "route": "cuda", "source": K2_SOURCE, "replaces": K2_REPLACES,
         "launches": k2_launches, "max_abs_err": k2_err, "ms": k2_ms,
         "plain_ms": k2_plain_ms, "bound_ms": k2_bound, "bound_by": k2_by,
         "library_ms": k2_lib_ms, "rel_l2_err": k2_rel,
         "blocks": str(k2_blocks), "prefill_ms": prefill_ms},
        {"name": f"flash_decode[{LM_ARCH} B={DECODE_B} S={MAX_SEQ} "
                 f"bf16 cache]",
         "route": "cuda", "source": K3_SOURCE, "replaces": K3_REPLACES,
         "launches": k3_launches, "max_abs_err": k3_err, "ms": k3_ms,
         "plain_ms": k3_plain_ms, "bound_ms": k3_bound, "bound_by": k3_by,
         "library_ms": k3_lib_ms, "rel_l2_err": k3_rel,
         "blocks": k3_blocks, "decode_step_ms": step_ms},
    ]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core import ALL_PROGRAMS, compile_program
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import kernel as k2
    from repro_torch.kernels.flash_decode import kernel as k3
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

    # 2. build every kernel in parallel: K1 for the 15 programs, K2, K3
    plans = {n: compile_program(b(), backend="interp_torch",
                                device=dev).kernel_plan
             for n, b in sorted(ALL_PROGRAMS.items())}
    calls = [c for kp in plans.values() for c in kp.calls if c.has_grid]
    t0 = time.perf_counter()
    _, built = build.build([*(k1.job(c) for c in calls), k2.job(), k3.job()])
    print(f"build: {len(calls)} stencil calls + flash attention + flash "
          f"decode, {built} sources compiled in "
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

    # 5. attention conformance on the card
    t0 = time.perf_counter()
    for (kern, dts), (e, r) in sorted(attention_conformance(dev).items()):
        print(f"conformance {kern:15s} {dts:30s} max_abs_err: {e:.3e}  "
              f"rel_l2_err: {r:.3e}", flush=True)
    print(f"attention conformance: {time.perf_counter() - t0:.1f} s",
          flush=True)

    # 6. the LM main path at full width
    entries += serve_lm(dev, flush, rate, smi)

    # 7. the kernels line, the card, and the result
    print(json.dumps({"kernels": entries}))
    print(bench.smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
