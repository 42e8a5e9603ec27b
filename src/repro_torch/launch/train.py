"""Training launcher: data -> train_step -> metrics, checkpoints,
heartbeat (the port of ``repro.launch.train``).

Runs on the current CUDA device unless ``device="cpu"`` is passed
(``--device cpu`` on the command line); without a card and without that
argument it raises.  Checkpoint-restart is exact: the synthetic data is
a pure function of the step and checkpoints commit atomically, so a
resumed run reproduces the uninterrupted one.

CLI::

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \\
        --smoke --device cpu --steps 5 [--ckpt-dir DIR [--resume]]
"""
from __future__ import annotations

import argparse
import time

import torch

from ..ckpt.checkpoint import latest_step, prune, restore, save
from ..configs import get_arch, smoke
from ..core.interpreters import resolve_device
from ..data.pipeline import DataCfg, SyntheticTokens
from ..ft.watchdog import Heartbeat, StragglerDetector
from ..models import init_params
from ..optim.adamw import AdamWCfg, init_opt_state
from ..train.step import make_train_step


def make_step(cfg, *, steps: int, lr: float = 1e-3, microbatches: int = 1):
    """The step function :func:`train_loop` runs: AdamW with the
    loop's schedule (warmup ``min(20, steps // 5 + 1)``, cosine over
    ``steps``)."""
    opt_cfg = AdamWCfg(lr=lr, warmup_steps=min(20, steps // 5 + 1),
                       total_steps=steps)
    return make_train_step(cfg, opt_cfg, microbatches=microbatches)


def train_loop(cfg, *, steps: int, batch: int, seq: int,
               ckpt_dir: str | None, resume: bool = False,
               ckpt_every: int = 50, lr: float = 1e-3,
               microbatches: int = 1, log_every: int = 10, host_id: int = 0,
               stop_after: int | None = None, device=None, seed: int = 0):
    """Train ``cfg`` from parameters drawn with ``seed`` for ``steps``
    steps of ``batch`` x ``seq`` synthetic tokens; returns ``(params,
    opt_state, losses)``.  ``stop_after`` simulates a crash after that
    many steps (no final checkpoint); the schedule always follows
    ``steps``."""
    dev = resolve_device(device)
    step_fn = make_step(cfg, steps=steps, lr=lr, microbatches=microbatches)
    data = SyntheticTokens(DataCfg(cfg.vocab, seq, batch))
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = init_params(gen, cfg, device=dev)
    opt = init_opt_state(params)
    start = 0
    if resume and ckpt_dir:
        last = latest_step(ckpt_dir)
        if last is not None:
            state = restore(ckpt_dir, last, {"params": params, "opt": opt})
            params, opt = state["params"], state["opt"]
            start = last
            print(f"resumed from step {last}")
    hb = Heartbeat(ckpt_dir, host_id) if ckpt_dir else None
    straggler = StragglerDetector()
    losses = []
    for step in range(start, steps):
        t0 = time.time()
        b = {k: torch.from_numpy(v).to(dev)
             for k, v in data.batch(step).items()}
        params, opt, metrics = step_fn(params, opt, b)
        losses.append(float(metrics["loss"]))
        dt = time.time() - t0
        straggler.record(host_id, dt)
        if hb:
            hb.beat(step, {"loss": losses[-1]})
        if step % log_every == 0 or step == steps - 1:
            print(f"step {step:5d} loss {losses[-1]:.4f} "
                  f"lr {float(metrics['lr']):.2e} {dt * 1e3:.0f}ms")
        if ckpt_dir and (step + 1) % ckpt_every == 0:
            save(ckpt_dir, step + 1, {"params": params, "opt": opt})
            prune(ckpt_dir, keep=3)
        if stop_after is not None and step + 1 >= stop_after:
            return params, opt, losses  # simulated crash: no final save
    if ckpt_dir:
        save(ckpt_dir, steps, {"params": params, "opt": opt})
    return params, opt, losses


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="Train one of the port's "
                                 "architectures on synthetic tokens.")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default=None,
                    help="'cpu' to train on the CPU (default: the current "
                         "CUDA device)")
    args = ap.parse_args(argv)

    cfg = get_arch(args.arch)
    if args.smoke:
        cfg = smoke(cfg)
    _, _, losses = train_loop(
        cfg, steps=args.steps, batch=args.batch, seq=args.seq,
        ckpt_dir=args.ckpt_dir, resume=args.resume, lr=args.lr,
        microbatches=args.microbatches, device=args.device)
    print(f"final loss {losses[-1]:.4f} (first {losses[0]:.4f})")


if __name__ == "__main__":
    main()
