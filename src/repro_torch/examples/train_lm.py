"""End-to-end training driver on the port: a ~100M-parameter LM (the
port of the reference's ``examples/train_lm.py``).

A narrow qwen3-family config (~100M parameters at the defaults) through
the whole substrate: the synthetic data pipeline, AdamW, remat,
checkpoints with atomic commits, heartbeats and straggler hooks, exact
resume.  Runs on the card unless ``--device cpu`` (where ~100M
parameters are slow; ``--d-model 64 --layers 2 --steps 5`` is a quick
demonstration)::

    PYTHONPATH=src python -m repro_torch.examples.train_lm --steps 200 \\
        --ckpt-dir DIR [--resume] [--device cpu]
"""
from __future__ import annotations

import argparse

from ..configs import get_arch
from ..launch.train import train_loop


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--d-model", type=int, default=512)
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default=None,
                    help="'cpu' to run on the CPU (default: the card)")
    args = ap.parse_args(argv)

    # ~100M parameters at the defaults: 2 * 32768 * 512 embed + 8 layers
    cfg = get_arch("qwen3-0.6b").replace(
        n_layers=args.layers,
        d_model=args.d_model,
        n_heads=8, n_kv_heads=4, head_dim=64,
        d_ff=4 * args.d_model,
        vocab=32768,
        dtype="float32",
        remat="none",
        attn_impl="chunked",
        attn_chunk=256,
    )
    n = cfg.n_params()
    print(f"config: {cfg.n_layers}L d={cfg.d_model} ~{n / 1e6:.0f}M params")
    _, _, losses = train_loop(
        cfg, steps=args.steps, batch=args.batch, seq=args.seq,
        ckpt_dir=args.ckpt_dir, resume=args.resume, ckpt_every=50,
        device=args.device)
    print(f"loss: {losses[0]:.3f} -> {losses[-1]:.3f} over {len(losses)} "
          f"steps")
    assert losses[-1] < losses[0], "training must reduce loss"


if __name__ == "__main__":
    main()
