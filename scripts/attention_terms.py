#!/usr/bin/env python3
"""How many float16 terms K2 (flash attention) needs for P, on one CUDA
device.

    python3 scripts/attention_terms.py

Builds ``flash_attention.cu`` three times, with P split in one, two and
three float16 terms (``-DFA_F16_TERMS``, here a ``#define`` put before
the source), and runs each on random float16 q, k and v (seeded) at
S = 257 and 2048, D = 64 and 128, causal, B = 1, 2 query heads over one
KV head.  For each it prints the relative L2 distance of the output to
the plain version (float32 arithmetic, one float16 rounding of the
output) and to the float32 function on the same inputs, and the
kernel's time (CUDA events around each launch, the host's enqueue
inside, no L2 flush; median of 20 after a warm-up).  Then the card's
name and power limit.  The kernel the port builds takes two terms (the
comment in ``flash_attention.cu`` has the measurement).
"""
from __future__ import annotations

import json
import pathlib
import statistics
import subprocess
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as k2  # noqa: E402

TERMS = (1, 2, 3)
SHAPES = ((257, 64), (257, 128), (2048, 64), (2048, 128))
RUNS = 20


def rel_l2(got, want) -> float:
    return float((got.float() - want.float()).norm() / want.float().norm())


def device_ms(fn) -> float:
    fn()
    times = []
    for _ in range(RUNS):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def main() -> int:
    if not torch.cuda.is_available():
        print("attention_terms: no CUDA device", file=sys.stderr)
        return 1
    src = k2.SOURCE.read_text()
    jobs = [build.Job(f"#define FA_F16_TERMS {t}\n" + src, (), k2.CSRC,
                      k2._bind) for t in TERMS]
    libs = dict(zip(TERMS, build.build(jobs)[0]))
    gen = torch.Generator(device="cuda").manual_seed(11)
    stream = torch.cuda.current_stream().cuda_stream
    for S, D in SHAPES:
        q, k, v = (torch.randn((1, S, h, D), generator=gen,
                               device="cuda").half() for h in (2, 1, 1))
        run = dict(causal=True, window=None, q_offset=0, scale=D ** -0.5)
        plain = k2.flash_attention_plain(q, k, v, **run)
        exact = k2.flash_attention_plain(q.float(), k.float(), v.float(),
                                         **run)
        row = {"S": S, "D": D, "plain_vs_f32_fn": rel_l2(plain, exact)}
        for t, lib in libs.items():
            o = torch.empty_like(q)

            def launch():
                k2.launch(lib, q, k, v, o, stream=stream, **run)
            launch()
            torch.cuda.synchronize()
            row[f"terms={t}"] = {"vs_plain": rel_l2(o, plain),
                                 "vs_f32_fn": rel_l2(o, exact),
                                 "ms": device_ms(launch)}
        print(json.dumps(row), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
