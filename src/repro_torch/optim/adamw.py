"""AdamW with decoupled weight decay, global-norm clipping, a cosine
schedule and optional gradient compression (the port of
``repro.optim.adamw``).

The update runs over the port's parameter tree (nested dictionaries,
and lists of per-layer dictionaries under ``blocks`` and
``enc_blocks``) and computes as the reference does: in float32, with
one global clip scale, ``b1 ** step`` with the step as float32, and the
decay ``weight_decay * p`` inside the step.  ``torch.optim.AdamW``
orders the decay differently and clips nothing, so the update is
written out here.  It is functional: new tensors come back and the
caller's are left as they were.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from ..tree import tree_leaves, tree_map


@dataclass(frozen=True)
class AdamWCfg:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_ratio: float = 0.1
    # 'none' | 'bf16': compress gradients before the DP all-reduce.
    grad_compression: str = "none"


def init_opt_state(params) -> dict:
    """Zero ``m`` and ``v`` like the parameters, and ``step`` 0 (int32,
    on the parameters' device)."""
    leaf = tree_leaves(params)[0]
    return {"m": tree_map(torch.zeros_like, params),
            "v": tree_map(torch.zeros_like, params),
            "step": torch.zeros((), dtype=torch.int32, device=leaf.device)}


def lr_at(cfg: AdamWCfg, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup, then cosine decay to ``min_lr_ratio * lr``; float32
    on ``step``'s device."""
    s = step.float()
    warm = torch.clamp(s / max(cfg.warmup_steps, 1), max=1.0)
    t = torch.clamp((s - cfg.warmup_steps)
                    / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * t))
    return cfg.lr * warm * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in tree_leaves(tree)))


def compress_grads(grads, mode: str):
    """Gradient compression hook: ``"bf16"`` rounds every gradient to
    bf16 and back (half the all-reduce bytes); ``"none"`` passes them
    through."""
    if mode == "bf16":
        return tree_map(lambda g: g.to(torch.bfloat16).float(), grads)
    if mode != "none":
        raise ValueError(f"grad_compression must be 'none' or 'bf16', got "
                         f"{mode!r}")
    return grads


@torch.no_grad()
def adamw_update(cfg: AdamWCfg, params, grads, state: dict):
    """One step: ``(new params, new state, {"lr", "grad_norm"})``."""
    step = state["step"] + 1
    lr = lr_at(cfg, step)
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    b1, b2 = cfg.b1, cfg.b2
    bias1 = 1 - torch.pow(b1, step.float())
    bias2 = 1 - torch.pow(b2, step.float())

    def upd(p, g, m, v):
        g = g.float() * scale
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        mhat = m / bias1
        vhat = v / bias2
        return (p - lr * (mhat / (torch.sqrt(vhat) + cfg.eps)
                          + cfg.weight_decay * p), m, v)

    out = tree_map(upd, params, grads, state["m"], state["v"])
    new_p, new_m, new_v = (tree_map(lambda _, t, i=i: t[i], params, out)
                           for i in range(3))
    return new_p, {"m": new_m, "v": new_v, "step": step}, \
        {"lr": lr, "grad_norm": gnorm}
