"""Training step: loss, gradients, AdamW update (the port of
``repro.train.step``).

Mixed precision: float32 master parameters, ``cfg.dtype`` compute (the
model casts each block, differentiably), float32 logits, loss and
optimizer.  Microbatch gradient accumulation is a loop over the
microbatches summing float32 gradients.  The moe family's load-balance
loss is added with a fixed coefficient.

The step differentiates the plain routes only: with
``attn_impl="pallas"`` the forward-only kernels K2-K4 raise under grad
(:mod:`repro_torch.kernels._grad`), as the reference cannot
differentiate its Pallas kernels; train with ``attn_impl="chunked"``
(the configs' default).
"""
from __future__ import annotations

import torch

from ..configs.base import ArchConfig
from ..distributed.ctx import whole
from ..models import forward
from ..optim.adamw import AdamWCfg, adamw_update, compress_grads
from ..tree import tree_leaves, tree_map

AUX_COEF = 0.01


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor
                  ) -> torch.Tensor:
    """logits (B, S, V) float32, targets (B, S) int: the mean of
    logsumexp minus the gold logit."""
    lse = torch.logsumexp(logits, dim=-1)
    # DTensor's gather along a sharded vocab leaves a masked partial sum
    # it cannot reduce: take the gold logits from whole rows
    gold = torch.gather(whole(logits, -1), -1,
                        targets[..., None].long())[..., 0]
    return (lse - gold).mean()


def loss_fn(params: dict, batch: dict, cfg: ArchConfig):
    """``(loss, {"loss", "aux"})``; ``batch["targets"]`` is already the
    next-token shift of ``batch["tokens"]`` (the data pipeline emits
    it), so every position scores against its own label."""
    out = forward(params, batch, cfg, mode="train")
    loss = cross_entropy(out["logits"], batch["targets"])
    loss = loss + AUX_COEF * out["aux"]
    return loss, {"loss": loss, "aux": out["aux"]}


def value_and_grad(params: dict, batch: dict, cfg: ArchConfig):
    """``((loss, metrics), grads)`` of :func:`loss_fn`, as
    ``jax.value_and_grad(loss_fn, has_aux=True)``: the values detached,
    the gradients float32 in the parameters' structure (zeros where a
    parameter does not reach the loss)."""
    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    it = iter(leaves)
    live = tree_map(lambda _: next(it), params)
    with torch.enable_grad():
        loss, metrics = loss_fn(live, batch, cfg)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    it = iter(torch.zeros_like(p) if g is None else g
              for p, g in zip(leaves, grads))
    return ((loss.detach(), {k: v.detach() for k, v in metrics.items()}),
            tree_map(lambda _: next(it), params))


def split_microbatches(batch: dict, n: int) -> list[dict]:
    """``n`` microbatches along the batch axis: axis 0, but axis 1 of
    M-RoPE ``positions`` (3, B, S)."""
    def split(key, x):
        ax = 1 if key == "positions" else 0
        if x.shape[ax] % n:
            raise ValueError(f"batch {x.shape[ax]} of {key!r} does not "
                             f"split into {n} microbatches")
        return torch.chunk(x, n, dim=ax)

    parts = {k: split(k, v) for k, v in batch.items()}
    return [{k: v[i] for k, v in parts.items()} for i in range(n)]


def make_train_step(cfg: ArchConfig, opt_cfg: AdamWCfg, *,
                    microbatches: int = 1):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``; the batch's tensors lie on the parameters' device."""

    def train_step(params, opt_state, batch):
        if microbatches > 1:
            grads = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                             params)
            loss = torch.zeros((), dtype=torch.float32,
                               device=tree_leaves(params)[0].device)
            for mb in split_microbatches(batch, microbatches):
                (l, _), g = value_and_grad(params, mb, cfg)
                grads = tree_map(torch.add, grads, g)
                loss = loss + l
            grads = tree_map(lambda g: g / microbatches, grads)
            metrics = {"loss": loss / microbatches}
        else:
            (_, metrics), grads = value_and_grad(params, batch, cfg)
        grads = compress_grads(grads, opt_cfg.grad_compression)
        params, opt_state, om = adamw_update(opt_cfg, params, grads,
                                             opt_state)
        metrics = dict(metrics)
        metrics.update(om)
        return params, opt_state, metrics

    return train_step
