"""Model assembly: the dense family (the port of ``repro.models.lm``).

Parameters are a plain dictionary of float32 master tensors with the
reference's names and ``(d_in, d_out)`` weight layout; ``blocks`` is a
list with one dictionary per layer where the reference stacks a leading
layer axis, and a Python loop over the layers takes the place of
``lax.scan``.  Every parameter is rounded to the compute dtype
(``cfg.dtype``) before use, norm scales included, as the reference's
``_cast`` does (the final norm's scale stays float32, as there);
parameters already in that dtype are used as they are.

Entry points:
  init_params(gen, cfg, device=)           -> parameter dictionary
  forward(params, batch, cfg, mode=)       -> {'logits', 'aux'[, 'caches']}
  init_caches(cfg, batch, max_seq, device=) -> {'k', 'v'}
  decode_step(params, token, caches, lengths, cfg) -> logits

Only the ``dense`` family is ported; the others raise
``NotImplementedError`` naming their item in ``ROADMAP.md``.
"""
from __future__ import annotations

import torch

from ..configs.base import ArchConfig
from ..core.interpreters import resolve_device
from .attention import attn_init, decode_self_attention, self_attention
from .common import DTYPES, dense_init, embed_init, rmsnorm, rmsnorm_init
from .mlp import swiglu, swiglu_init

#: Families still to port, and where ROADMAP.md lists them.
_NOT_PORTED = {
    "ssm": "Queue 1 item 6a (models/ssm.py and K4)",
    "hybrid": "Queue 1 item 6b (the hybrid family)",
    "moe": "Queue 1 item 6b (models/moe.py)",
    "encdec": "Queue 1 item 6b (the encoder-decoder family)",
    "vlm": "Queue 1 item 6b (the vlm family)",
}


def require_dense(cfg: ArchConfig) -> None:
    if cfg.family != "dense":
        where = _NOT_PORTED.get(cfg.family)
        if where is None:
            raise ValueError(f"unknown model family {cfg.family!r}")
        raise NotImplementedError(
            f"family {cfg.family!r} ({cfg.name}) is not ported yet: see "
            f"ROADMAP.md, {where}")


def _block_init(gen: torch.Generator, cfg: ArchConfig, device) -> dict:
    return {
        "ln1": rmsnorm_init(cfg.d_model, device=device),
        "attn": attn_init(gen, cfg, device=device),
        "ln2": rmsnorm_init(cfg.d_model, device=device),
        "mlp": swiglu_init(gen, cfg.d_model, cfg.d_ff, device=device),
    }


def init_params(gen: torch.Generator, cfg: ArchConfig, *,
                device=None) -> dict:
    """Random float32 masters from ``gen`` (a generator on ``device``:
    the current CUDA device unless ``device="cpu"`` is given)."""
    require_dense(cfg)
    dev = resolve_device(device)
    p = {
        "embed": embed_init(gen, cfg.vocab, cfg.d_model, device=dev),
        "final_norm": rmsnorm_init(cfg.d_model, device=dev),
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = dense_init(gen, cfg.d_model, cfg.vocab, device=dev)
    p["blocks"] = [_block_init(gen, cfg, dev) for _ in range(cfg.n_layers)]
    return p


def cast(tree, dtype: torch.dtype):
    """``tree`` with every float32 tensor rounded to ``dtype``."""
    if isinstance(tree, dict):
        return {k: cast(v, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [cast(v, dtype) for v in tree]
    return tree.to(dtype) if tree.dtype == torch.float32 else tree


def _head(params: dict) -> torch.Tensor:
    head = params.get("lm_head")
    return params["embed"].T if head is None else head


def _dense_block(bp: dict, x: torch.Tensor, cfg: ArchConfig, positions):
    h, kv = self_attention(bp["attn"], rmsnorm(x, bp["ln1"], cfg.norm_eps),
                           cfg, positions=positions, causal=True)
    x = x + h
    x = x + swiglu(bp["mlp"], rmsnorm(x, bp["ln2"], cfg.norm_eps))
    return x, kv


def forward(params: dict, batch: dict, cfg: ArchConfig, *,
            mode: str = "train", last_only: bool = False) -> dict:
    """batch: ``tokens`` (B, S) [+ ``positions`` (B, S)].

    Returns ``logits`` (B, S, V) float32 -- (B, 1, V) with
    ``last_only``, which is all a prefill needs -- ``aux`` (zero for the
    dense family) and, with ``mode="prefill"``, ``caches = (k, v)``, each
    stacked over the layers as (L, B, S, KVH, D)."""
    require_dense(cfg)
    if mode not in ("train", "prefill"):
        raise ValueError(f"mode must be 'train' or 'prefill', got {mode!r}")
    dt = DTYPES[cfg.dtype]
    tokens = batch["tokens"]
    B, S = tokens.shape
    x = params["embed"].to(dt)[tokens]
    positions = batch.get("positions")
    if positions is None:
        positions = torch.arange(S, device=x.device)[None].expand(B, S)
    ks, vs = [], []
    for bp in params["blocks"]:
        x, (k, v) = _dense_block(cast(bp, dt), x, cfg, positions)
        if mode == "prefill":
            ks.append(k)
            vs.append(v)
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    if last_only:
        x = x[:, -1:]
    logits = (x @ _head(params).to(dt)).float()
    out = {"logits": logits,
           "aux": torch.zeros((), dtype=torch.float32, device=x.device)}
    if mode == "prefill":
        out["caches"] = (torch.stack(ks), torch.stack(vs))
    return out


def init_caches(cfg: ArchConfig, batch: int, max_seq: int, *,
                cache_dtype: torch.dtype = torch.bfloat16,
                device=None) -> dict:
    """Zeroed KV caches, (L, B, max_seq, KVH, D) each, on ``device``
    (the current CUDA device unless ``device="cpu"`` is given)."""
    require_dense(cfg)
    dev = resolve_device(device)
    shape = (cfg.n_layers, batch, max_seq, cfg.n_kv_heads, cfg.hd)
    return {"k": torch.zeros(shape, dtype=cache_dtype, device=dev),
            "v": torch.zeros(shape, dtype=cache_dtype, device=dev)}


def decode_step(params: dict, token: torch.Tensor, caches: dict,
                lengths: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """token (B,) int; lengths (B,) int32 count the tokens, the new one
    included.  Writes each layer's new (k, v) into ``caches`` in place
    and returns the logits (B, V) float32."""
    require_dense(cfg)
    dt = DTYPES[cfg.dtype]
    x = params["embed"].to(dt)[token]  # (B, d)
    for layer, bp in enumerate(params["blocks"]):
        bp = cast(bp, dt)
        h = rmsnorm(x, bp["ln1"], cfg.norm_eps)
        h = decode_self_attention(bp["attn"], h, cfg,
                                  cache_k=caches["k"][layer],
                                  cache_v=caches["v"][layer],
                                  lengths=lengths)
        y = x + h
        ff = swiglu(bp["mlp"], rmsnorm(y, bp["ln2"], cfg.norm_eps)[:, None])
        x = y + ff[:, 0]
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return (x @ _head(params).to(dt)).float()
