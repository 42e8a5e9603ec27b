#!/usr/bin/env python3
"""Time K2 (flash attention) and K3 (flash decode) of one checkout of the
PyTorch/CUDA port at the serving paths' shapes, on one CUDA device.

    python3 scripts/attention_ab.py [--src DIR] [--tag NAME]

``--src`` is the ``src`` directory whose ``repro_torch`` is timed (by
default this checkout's).  To compare two versions of the kernels, run
it on both checkouts in one session on one card, in the order A, B, B,
A.  It uses only what every version of the port has: each kernel's
``prepare(...) -> (o, run)`` and its plain version.

Each call is checked against the plain version (relative L2 within
``1e-3``, ``chip_smoke.py``'s bf16 gate) and then timed two ways by CUDA
events, median of 20 runs after warm-up with the L2 flushed before each:
``device_ms`` with the device spinning while the host enqueues the call
(the device's time alone) and ``launch_ms`` with the host's launch
inside.  One ``scaled_dot_product_attention`` call on the same inputs is
timed both ways beside it.  Prints one JSON object per kernel and shape,
then the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import subprocess
import sys

import torch
import torch.nn.functional as F

RUNS = 20
SPIN = 2_000_000  # GPU cycles, about 1 ms on an H100
#: (name, H, KVH, D) of the served models' attention layers.
SHAPES = (("qwen3-0.6b", 16, 8, 128), ("zamba2-2.7b", 32, 32, 80))
B, S, MAX_SEQ, SHORT = 4, 2048, 4096, 31
REL_L2 = 1e-3


def timed(fn, flush, spin: int) -> float:
    for _ in range(3):
        fn()
    times = []
    for _ in range(RUNS):
        flush()
        if spin:
            torch.cuda._sleep(spin)
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times)


def both(fn, flush) -> dict:
    return {"device_ms": timed(fn, flush, SPIN),
            "launch_ms": timed(fn, flush, 0)}


def check(got, want, what: str) -> float:
    rel = float((got.float() - want.float()).norm() / want.float().norm())
    if not rel <= REL_L2:
        raise AssertionError(f"{what}: relative L2 {rel:.3e} > {REL_L2}")
    return rel


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(
        pathlib.Path(__file__).resolve().parents[1] / "src"))
    ap.add_argument("--tag", default="")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("attention_ab: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(pathlib.Path(args.src).resolve()))
    from repro_torch.kernels.flash_attention import kernel as k2
    from repro_torch.kernels.flash_decode import kernel as k3

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    flush = torch.empty(32 * 2**20, dtype=torch.float32, device=dev).zero_

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    for name, H, KVH, D in SHAPES:
        scale = D ** -0.5
        # K2 at the prefill shape, causal
        q, k, v = rnd(B, S, H, D), rnd(B, S, KVH, D), rnd(B, S, KVH, D)
        kw = dict(causal=True, window=None, q_offset=0, scale=scale)
        o, run = k2.prepare(q, k, v, **kw)
        run()
        rel = check(o, k2.flash_attention_plain(q, k, v, **kw), f"K2 {name}")
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        sdpa = both(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True), flush)
        print(json.dumps({"tag": args.tag, "kernel": "K2", "shape": name,
                          "B": B, "S": S, "H": H, "KVH": KVH, "D": D,
                          **both(run, flush), "rel_l2": rel,
                          "sdpa": sdpa}), flush=True)
        del q, k, v, o, qt, kt, vt
        # K3 over a full bf16 cache and at the main path's lengths
        q = rnd(B, H, D)
        kc, vc = rnd(B, MAX_SEQ, KVH, D), rnd(B, MAX_SEQ, KVH, D)
        for n in (MAX_SEQ, SHORT):
            lengths = torch.full((B,), n, dtype=torch.int32, device=dev)
            o, run = k3.prepare(q, kc, vc, lengths, window=None, scale=scale)
            run()
            rel = check(o, k3.flash_decode_plain(q, kc, vc, lengths,
                                                 window=None, scale=scale),
                        f"K3 {name} length {n}")
            kt, vt = (t[:, :n].transpose(1, 2).contiguous() for t in (kc, vc))
            sdpa = both(lambda: F.scaled_dot_product_attention(
                q[:, :, None], kt, vt, enable_gqa=True), flush)
            print(json.dumps({"tag": args.tag, "kernel": "K3", "shape": name,
                              "B": B, "S": MAX_SEQ, "length": n, "H": H,
                              "KVH": KVH, "D": D, **both(run, flush),
                              "rel_l2": rel, "sdpa": sdpa}), flush=True)
        del q, kc, vc, kt, vt
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(smi.strip().splitlines()[0])
    return 0


if __name__ == "__main__":
    sys.exit(main())
