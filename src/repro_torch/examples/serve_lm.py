"""Batched serving demo on the port: greedy decode with KV caches (the
port of the reference's ``examples/serve_lm.py``).

Builds a small dense LM (qwen3-0.6b's smoke config) with
``attn_impl="pallas"``, so the decode steps run the hand-written flash
decode kernel K3 and the teacher-forced forward the flash attention
kernel K2 (their plain versions with ``--device cpu``), serves a batch
of prompts (per-sequence lengths, cache writes at ``lengths - 1``) and
checks the serving-path property: the first generated token is the
teacher-forced forward's argmax::

    PYTHONPATH=src python -m repro_torch.examples.serve_lm [--device cpu]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from ..configs import ARCHS, smoke
from ..core.interpreters import resolve_device
from ..models import forward, init_params
from ..serve.engine import greedy_decode


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="'cpu' to run on the CPU (default: the card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = smoke(ARCHS["qwen3-0.6b"]).replace(attn_impl="pallas")
    params = init_params(torch.Generator(device=dev).manual_seed(7), cfg,
                         device=dev)
    rng = np.random.default_rng(0)
    B, S0, steps = 4, 12, 8
    prompts = torch.from_numpy(
        rng.integers(0, cfg.vocab, (B, S0)).astype(np.int32)).to(dev)

    out = greedy_decode(params, cfg, prompts, steps=steps, max_seq=64,
                        device=dev)
    print(f"served batch of {B}: prompts {tuple(prompts.shape)} -> "
          f"generated {tuple(out.shape)}")
    print(out)

    # consistency: the first generated token matches teacher-forced argmax
    with torch.no_grad():
        logits = forward(params, {"tokens": prompts}, cfg)["logits"]
    want = logits[:, -1].argmax(-1).to(torch.int32)
    got = out[:, 0]
    assert bool((want == got).all()), (want, got)
    print("decode path matches teacher-forced forward")


if __name__ == "__main__":
    main()
