"""Model assembly: the dense, ssm (Mamba2) and hybrid (Zamba2: a Mamba2
backbone and one shared-weight attention block after every
``attn_every`` layers) families, the port of ``repro.models.lm``.

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
  init_caches(cfg, batch, max_seq, device=) -> the family's decode caches
  decode_step(params, token, caches, lengths, cfg) -> logits

The other families raise ``NotImplementedError`` naming their item in
``ROADMAP.md``.
"""
from __future__ import annotations

import torch

from ..configs.base import ArchConfig
from ..core.interpreters import resolve_device
from .attention import attn_init, decode_self_attention, self_attention
from .common import DTYPES, dense_init, embed_init, rmsnorm, rmsnorm_init
from .mlp import swiglu, swiglu_init
from .ssm import (mamba_cache_init, mamba_decode_step, mamba_forward,
                  mamba_init)

#: Families ported.
PORTED = ("dense", "ssm", "hybrid")
#: Families still to port, and where ROADMAP.md lists them.
_NOT_PORTED = {
    "moe": "Queue 1 item 6b (models/moe.py)",
    "encdec": "Queue 1 item 6b (the encoder-decoder family)",
    "vlm": "Queue 1 item 6b (the vlm family)",
}


def require_ported(cfg: ArchConfig) -> None:
    """Raise unless ``cfg``'s family is ported."""
    if cfg.family in PORTED:
        if cfg.family == "hybrid" and cfg.n_layers % cfg.hybrid.attn_every:
            raise ValueError(f"{cfg.name}: {cfg.n_layers} layers do not "
                             f"group by attn_every="
                             f"{cfg.hybrid.attn_every}")
        return
    where = _NOT_PORTED.get(cfg.family)
    if where is None:
        raise ValueError(f"unknown model family {cfg.family!r}")
    raise NotImplementedError(
        f"family {cfg.family!r} ({cfg.name}) is not ported yet: see "
        f"ROADMAP.md, {where}")


def _dense_init(gen: torch.Generator, cfg: ArchConfig, device) -> dict:
    return {
        "ln1": rmsnorm_init(cfg.d_model, device=device),
        "attn": attn_init(gen, cfg, device=device),
        "ln2": rmsnorm_init(cfg.d_model, device=device),
        "mlp": swiglu_init(gen, cfg.d_model, cfg.d_ff, device=device),
    }


def _ssm_init(gen: torch.Generator, cfg: ArchConfig, device) -> dict:
    return {"ln1": rmsnorm_init(cfg.d_model, device=device),
            "mamba": mamba_init(gen, cfg, device=device)}


def init_params(gen: torch.Generator, cfg: ArchConfig, *,
                device=None) -> dict:
    """Random float32 masters from ``gen`` (a generator on ``device``:
    the current CUDA device unless ``device="cpu"`` is given)."""
    require_ported(cfg)
    dev = resolve_device(device)
    p = {
        "embed": embed_init(gen, cfg.vocab, cfg.d_model, device=dev),
        "final_norm": rmsnorm_init(cfg.d_model, device=dev),
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = dense_init(gen, cfg.d_model, cfg.vocab, device=dev)
    block = _dense_init if cfg.family == "dense" else _ssm_init
    p["blocks"] = [block(gen, cfg, dev) for _ in range(cfg.n_layers)]
    if cfg.family == "hybrid":
        p["shared_attn"] = _dense_init(gen, cfg, dev)
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


def _groups(cfg: ArchConfig, n: int) -> list[range]:
    """The hybrid family's groups of ``attn_every`` layers, in order."""
    every = cfg.hybrid.attn_every
    return [range(g * every, (g + 1) * every) for g in range(n // every)]


def _dense_block(bp: dict, x: torch.Tensor, cfg: ArchConfig, positions):
    h, kv = self_attention(bp["attn"], rmsnorm(x, bp["ln1"], cfg.norm_eps),
                           cfg, positions=positions, causal=True)
    x = x + h
    x = x + swiglu(bp["mlp"], rmsnorm(x, bp["ln2"], cfg.norm_eps))
    return x, kv


def _ssm_block(bp: dict, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    return x + mamba_forward(bp["mamba"], rmsnorm(x, bp["ln1"], cfg.norm_eps),
                             cfg)


def forward(params: dict, batch: dict, cfg: ArchConfig, *,
            mode: str = "train", last_only: bool = False) -> dict:
    """batch: ``tokens`` (B, S) [+ ``positions`` (B, S)].

    Returns ``logits`` (B, S, V) float32 -- (B, 1, V) with
    ``last_only``, which is all a prefill needs -- ``aux`` (zero for
    these families) and, with ``mode="prefill"``, ``caches``: for the
    dense family ``(k, v)``, each stacked over the layers as (L, B, S,
    KVH, D); for the hybrid family the shared block's ``(k, v)`` stacked
    over the groups; ``None`` for the ssm family (its prefill leaves no
    cache, as in the reference)."""
    require_ported(cfg)
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
    if cfg.family == "dense":
        for bp in params["blocks"]:
            x, (k, v) = _dense_block(cast(bp, dt), x, cfg, positions)
            ks.append(k)
            vs.append(v)
    elif cfg.family == "ssm":
        for bp in params["blocks"]:
            x = _ssm_block(cast(bp, dt), x, cfg)
    else:  # hybrid
        shared = cast(params["shared_attn"], dt)
        for group in _groups(cfg, len(params["blocks"])):
            for layer in group:
                x = _ssm_block(cast(params["blocks"][layer], dt), x, cfg)
            x, (k, v) = _dense_block(shared, x, cfg, positions)
            ks.append(k)
            vs.append(v)
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    if last_only:
        x = x[:, -1:]
    logits = (x @ _head(params).to(dt)).float()
    out = {"logits": logits,
           "aux": torch.zeros((), dtype=torch.float32, device=x.device)}
    if mode == "prefill":
        out["caches"] = (torch.stack(ks), torch.stack(vs)) if ks else None
    return out


def init_caches(cfg: ArchConfig, batch: int, max_seq: int, *,
                cache_dtype: torch.dtype = torch.bfloat16,
                device=None) -> dict:
    """Zeroed decode caches on ``device`` (the current CUDA device unless
    ``device="cpu"`` is given), laid out as the reference's:

    * dense: ``{"k", "v"}``, (L, B, max_seq, KVH, D) each;
    * ssm: ``{"conv": (L, B, W - 1, d_inner), "state": (L, B, H, N, P)
      float32}``;
    * hybrid: ``{"ssm": <the ssm caches>, "k", "v"}``, the KV caches of
      the shared block with the groups leading."""
    require_ported(cfg)
    dev = resolve_device(device)

    def kv(n: int) -> dict:
        shape = (n, batch, max_seq, cfg.n_kv_heads, cfg.hd)
        return {"k": torch.zeros(shape, dtype=cache_dtype, device=dev),
                "v": torch.zeros(shape, dtype=cache_dtype, device=dev)}

    if cfg.family == "dense":
        return kv(cfg.n_layers)
    ssm = mamba_cache_init(cfg, batch, cache_dtype, layers=cfg.n_layers,
                           device=dev)
    if cfg.family == "ssm":
        return ssm
    return {"ssm": ssm, **kv(cfg.n_layers // cfg.hybrid.attn_every)}


def _ssm_decode_layer(bp: dict, x: torch.Tensor, caches: dict, layer: int,
                      cfg: ArchConfig) -> torch.Tensor:
    h = rmsnorm(x, bp["ln1"], cfg.norm_eps)
    cache = {"conv": caches["conv"][layer], "state": caches["state"][layer]}
    return x + mamba_decode_step(bp["mamba"], h, cache, cfg)


def _dense_decode_layer(bp: dict, x: torch.Tensor, cache_k: torch.Tensor,
                        cache_v: torch.Tensor, lengths: torch.Tensor,
                        cfg: ArchConfig) -> torch.Tensor:
    h = rmsnorm(x, bp["ln1"], cfg.norm_eps)
    h = decode_self_attention(bp["attn"], h, cfg, cache_k=cache_k,
                              cache_v=cache_v, lengths=lengths)
    y = x + h
    ff = swiglu(bp["mlp"], rmsnorm(y, bp["ln2"], cfg.norm_eps)[:, None])
    return y + ff[:, 0]


def decode_step(params: dict, token: torch.Tensor, caches: dict,
                lengths: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """token (B,) int; lengths (B,) int32 count the tokens, the new one
    included.  Writes each layer's new KV entries, conv window and SSM
    state into ``caches`` in place and returns the logits (B, V)
    float32."""
    require_ported(cfg)
    dt = DTYPES[cfg.dtype]
    x = params["embed"].to(dt)[token]  # (B, d)
    blocks = params["blocks"]
    if cfg.family == "dense":
        for layer, bp in enumerate(blocks):
            x = _dense_decode_layer(cast(bp, dt), x, caches["k"][layer],
                                    caches["v"][layer], lengths, cfg)
    elif cfg.family == "ssm":
        for layer, bp in enumerate(blocks):
            x = _ssm_decode_layer(cast(bp, dt), x, caches, layer, cfg)
    else:  # hybrid
        shared = cast(params["shared_attn"], dt)
        for g, group in enumerate(_groups(cfg, len(blocks))):
            for layer in group:
                x = _ssm_decode_layer(cast(blocks[layer], dt), x,
                                      caches["ssm"], layer, cfg)
            x = _dense_decode_layer(shared, x, caches["k"][g],
                                    caches["v"][g], lengths, cfg)
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return (x @ _head(params).to(dt)).float()
