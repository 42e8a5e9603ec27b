"""Model assembly, the port of ``repro.models.lm``: the dense, vlm
(M-RoPE), moe, ssm (Mamba2), hybrid (Zamba2: a Mamba2 backbone and one
shared-weight attention block after every ``attn_every`` layers) and
encdec (Whisper's backbone; the audio frontend is a stub, so callers pass
frame embeddings as ``batch["enc_frames"]``) families.

Parameters are a plain dictionary of float32 master tensors with the
reference's names and ``(d_in, d_out)`` weight layout; ``blocks`` (and
encdec's ``enc_blocks``) is a list with one dictionary per layer where
the reference stacks a leading layer axis, and a Python loop over the
layers takes the place of ``lax.scan``.  Every parameter is rounded to
the compute dtype (``cfg.dtype``) before use, norm scales included, as
the reference's ``_cast`` does (the final norms' parameters stay
float32, as there); parameters already in that dtype are used as they
are.

Under autograd (``forward(..., mode="train")`` with grad mode on) each
block (a hybrid group, as the reference's scan body) is rematerialized
by ``cfg.remat``: ``"full"`` recomputes it in the backward pass
(``torch.utils.checkpoint``), ``"dots"`` keeps the matrix products'
outputs and recomputes the rest (the reference's ``checkpoint_dots``),
``"none"`` keeps everything; without grad (serving) nothing is wrapped.

Entry points:
  init_params(gen, cfg, device=)           -> parameter dictionary
  forward(params, batch, cfg, mode=)       -> {'logits', 'aux'[, 'caches']}
  init_caches(cfg, batch, max_seq, device=) -> the family's decode caches
  decode_step(params, token, caches, lengths, cfg) -> logits
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..configs.base import ArchConfig
from ..core.interpreters import resolve_device
from ..distributed.ctx import constrain, lookup
from ..tree import tree_map
from .attention import (attn_init, cross_attention, decode_self_attention,
                        encode_cross_kv, self_attention)
from .common import (DTYPES, dense_init, embed_init, layernorm,
                     layernorm_init, rmsnorm, rmsnorm_init, sinusoidal_at,
                     sinusoidal_positions)
from .mlp import gelu_mlp, gelu_mlp_init, swiglu, swiglu_init
from .moe import moe_ffn, moe_init
from .ssm import (mamba_cache_init, mamba_decode_step, mamba_forward,
                  mamba_init)

#: Families ported: all of the reference's.
PORTED = ("dense", "vlm", "moe", "ssm", "hybrid", "encdec")
#: The kind of block each family stacks in ``blocks``.
_BLOCK_KIND = {"dense": "dense", "vlm": "dense", "moe": "moe", "ssm": "ssm",
               "hybrid": "ssm", "encdec": "dec"}


def require_ported(cfg: ArchConfig) -> None:
    """Raise unless ``cfg``'s family is one the port knows and its layers
    group as the family needs."""
    if cfg.family not in PORTED:
        raise ValueError(f"unknown model family {cfg.family!r}")
    if cfg.family == "hybrid" and cfg.n_layers % cfg.hybrid.attn_every:
        raise ValueError(f"{cfg.name}: {cfg.n_layers} layers do not "
                         f"group by attn_every={cfg.hybrid.attn_every}")


def _block_init(gen: torch.Generator, cfg: ArchConfig, kind: str,
                device) -> dict:
    d = cfg.d_model
    if kind == "dense":
        return {"ln1": rmsnorm_init(d, device=device),
                "attn": attn_init(gen, cfg, device=device),
                "ln2": rmsnorm_init(d, device=device),
                "mlp": swiglu_init(gen, d, cfg.d_ff, device=device)}
    if kind == "moe":
        return {"ln1": rmsnorm_init(d, device=device),
                "attn": attn_init(gen, cfg, device=device),
                "ln2": rmsnorm_init(d, device=device),
                "moe": moe_init(gen, cfg, device=device)}
    if kind == "ssm":
        return {"ln1": rmsnorm_init(d, device=device),
                "mamba": mamba_init(gen, cfg, device=device)}
    if kind == "enc":
        return {"ln1": layernorm_init(d, device=device),
                "attn": attn_init(gen, cfg, device=device),
                "ln2": layernorm_init(d, device=device),
                "mlp": gelu_mlp_init(gen, d, cfg.d_ff, device=device)}
    if kind == "dec":
        return {"ln1": layernorm_init(d, device=device),
                "self_attn": attn_init(gen, cfg, device=device),
                "ln2": layernorm_init(d, device=device),
                "cross_attn": attn_init(gen, cfg, device=device),
                "ln3": layernorm_init(d, device=device),
                "mlp": gelu_mlp_init(gen, d, cfg.d_ff, device=device)}
    raise ValueError(f"unknown block kind {kind!r}")


def init_params(gen: torch.Generator, cfg: ArchConfig, *,
                device=None) -> dict:
    """Random float32 masters from ``gen`` (a generator on ``device``:
    the current CUDA device unless ``device="cpu"`` is given)."""
    require_ported(cfg)
    dev = resolve_device(device)
    encdec = cfg.family == "encdec"
    p = {
        "embed": embed_init(gen, cfg.vocab, cfg.d_model, device=dev),
        "final_norm": (layernorm_init if encdec else rmsnorm_init)(
            cfg.d_model, device=dev),
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = dense_init(gen, cfg.d_model, cfg.vocab, device=dev)
    kind = _BLOCK_KIND[cfg.family]
    p["blocks"] = [_block_init(gen, cfg, kind, dev)
                   for _ in range(cfg.n_layers)]
    if cfg.family == "hybrid":
        p["shared_attn"] = _block_init(gen, cfg, "dense", dev)
    if encdec:
        p["enc_blocks"] = [_block_init(gen, cfg, "enc", dev)
                           for _ in range(cfg.encdec.n_enc_layers)]
        p["enc_norm"] = layernorm_init(cfg.d_model, device=dev)
    return p


def cast(tree, dtype: torch.dtype):
    """``tree`` with every float32 tensor rounded to ``dtype``."""
    return tree_map(lambda t: t.to(dtype) if t.dtype == torch.float32
                    else t, tree)


def _head(params: dict) -> torch.Tensor:
    head = params.get("lm_head")
    return params["embed"].T if head is None else head


def _groups(cfg: ArchConfig, n: int) -> list[range]:
    """The hybrid family's groups of ``attn_every`` layers, in order."""
    every = cfg.hybrid.attn_every
    return [range(g * every, (g + 1) * every) for g in range(n // every)]


#: The matrix products whose outputs ``remat="dots"`` keeps (``einsum``
#: and ``@`` reach these).
_DOTS = frozenset({torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
                   torch.ops.aten.addmm.default,
                   torch.ops.aten.baddbmm.default})


def _save_dots(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _dots_context():
    return create_selective_checkpoint_contexts(_save_dots)


def _remat(fn, cfg: ArchConfig):
    """``fn`` rematerialized as ``cfg.remat`` says, when autograd
    records (the port of the reference's ``_remat``)."""
    if cfg.remat not in ("full", "dots", "none"):
        raise ValueError(f"remat must be 'full', 'dots' or 'none', got "
                         f"{cfg.remat!r}")
    if cfg.remat == "none" or not torch.is_grad_enabled():
        return fn
    if cfg.remat == "dots":
        return lambda *a: checkpoint(fn, *a, use_reentrant=False,
                                     context_fn=_dots_context)
    return lambda *a: checkpoint(fn, *a, use_reentrant=False)


def _dense_block(bp: dict, x: torch.Tensor, cfg: ArchConfig, positions):
    h, kv = self_attention(bp["attn"], rmsnorm(x, bp["ln1"], cfg.norm_eps),
                           cfg, positions=positions, causal=True)
    x = x + h
    x = x + swiglu(bp["mlp"], rmsnorm(x, bp["ln2"], cfg.norm_eps))
    return x, kv


def _moe_block(bp: dict, x: torch.Tensor, cfg: ArchConfig, positions):
    h, kv = self_attention(bp["attn"], rmsnorm(x, bp["ln1"], cfg.norm_eps),
                           cfg, positions=positions, causal=True)
    x = x + h
    y, aux = moe_ffn(bp["moe"], rmsnorm(x, bp["ln2"], cfg.norm_eps), cfg)
    return x + y, kv, aux


def _ssm_block(bp: dict, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    return x + mamba_forward(bp["mamba"], rmsnorm(x, bp["ln1"], cfg.norm_eps),
                             cfg)


def _enc_block(bp: dict, x: torch.Tensor, cfg: ArchConfig, positions):
    h, _ = self_attention(bp["attn"], layernorm(x, bp["ln1"], cfg.norm_eps),
                          cfg, positions=positions, causal=False)
    x = x + h
    return x + gelu_mlp(bp["mlp"], layernorm(x, bp["ln2"], cfg.norm_eps))


def _dec_block(bp: dict, x: torch.Tensor, enc_out: torch.Tensor,
               cfg: ArchConfig, positions):
    h, kv = self_attention(bp["self_attn"],
                           layernorm(x, bp["ln1"], cfg.norm_eps), cfg,
                           positions=positions, causal=True)
    x = x + h
    enc_kv = encode_cross_kv(bp["cross_attn"], enc_out, cfg)
    x = x + cross_attention(bp["cross_attn"],
                            layernorm(x, bp["ln2"], cfg.norm_eps), enc_kv,
                            cfg)
    x = x + gelu_mlp(bp["mlp"], layernorm(x, bp["ln3"], cfg.norm_eps))
    return x, kv, enc_kv


def _encode(params: dict, frames: torch.Tensor, cfg: ArchConfig,
            dt: torch.dtype) -> torch.Tensor:
    """The encoder over the stub frontend's frame embeddings (B, Se, d):
    sinusoidal positions (and rope, as the reference applies it in every
    self attention), the blocks, then ``enc_norm``."""
    x = frames.to(dt)
    B, Se = x.shape[:2]
    x = x + sinusoidal_positions(Se, cfg.d_model,
                                 device=x.device).to(dt)[None]
    positions = torch.arange(Se, device=x.device)[None].expand(B, Se)
    block = _remat(lambda bp, x: _enc_block(cast(bp, dt), x, cfg, positions),
                   cfg)
    for bp in params["enc_blocks"]:
        x = constrain(block(bp, x), "b", None, "m")
    return layernorm(x, params["enc_norm"], cfg.norm_eps)


def _stacked(kvs: list):
    """Per-layer ``(k, v)`` pairs stacked over the layers."""
    return torch.stack([k for k, _ in kvs]), torch.stack([v for _, v in kvs])


def _final_norm(params: dict, x: torch.Tensor, cfg: ArchConfig):
    if cfg.family == "encdec":
        return layernorm(x, params["final_norm"], cfg.norm_eps)
    return rmsnorm(x, params["final_norm"], cfg.norm_eps)


def forward(params: dict, batch: dict, cfg: ArchConfig, *,
            mode: str = "train", last_only: bool = False) -> dict:
    """batch: ``tokens`` (B, S) [+ ``positions`` (B, S), or (3, B, S)
    for M-RoPE] [+ ``enc_frames`` (B, Se, d) for encdec].

    Returns ``logits`` (B, S, V) float32 -- (B, 1, V) with
    ``last_only``, which is all a prefill needs -- ``aux`` (the moe
    layers' load-balance losses summed, zero for the other families)
    and, with ``mode="prefill"``, ``caches``: ``(k, v)``, each stacked
    over the layers as (L, B, S, KVH, D), for the dense, vlm and moe
    families; for the hybrid family the shared block's ``(k, v)``
    stacked over the groups; for encdec ``((k, v), (enc_k, enc_v))``,
    the self attention's and the cross attention's encoder K/V (L, B,
    Se, KVH, D); ``None`` for the ssm family (its prefill leaves no
    cache, as in the reference)."""
    require_ported(cfg)
    if mode not in ("train", "prefill"):
        raise ValueError(f"mode must be 'train' or 'prefill', got {mode!r}")
    dt = DTYPES[cfg.dtype]
    fam = cfg.family
    tokens = batch["tokens"]
    B, S = tokens.shape
    x = constrain(lookup(params["embed"].to(dt), tokens), "b", None, "m")
    positions = batch.get("positions")
    if positions is None:
        positions = torch.arange(S, device=x.device)[None].expand(B, S)
        if cfg.mrope_sections is not None:
            positions = positions[None].expand(3, B, S)
    # only a prefill keeps the per-layer K/V (in training they would stay
    # alive, remat or not)
    collect = mode == "prefill"
    kvs, enc_kvs = [], []
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if fam in ("dense", "vlm"):
        block = _remat(lambda bp, x: _dense_block(cast(bp, dt), x, cfg,
                                                  positions), cfg)
        for bp in params["blocks"]:
            x, kv = block(bp, x)
            x = constrain(x, "b", None, "m")
            if collect:
                kvs.append(kv)
    elif fam == "moe":
        block = _remat(lambda bp, x: _moe_block(cast(bp, dt), x, cfg,
                                                positions), cfg)
        for bp in params["blocks"]:
            x, kv, a = block(bp, x)
            x = constrain(x, "b", None, "m")
            if collect:
                kvs.append(kv)
            aux = aux + a
    elif fam == "ssm":
        block = _remat(lambda bp, x: _ssm_block(cast(bp, dt), x, cfg), cfg)
        for bp in params["blocks"]:
            x = constrain(block(bp, x), "b", None, "m")
    elif fam == "hybrid":
        shared = cast(params["shared_attn"], dt)

        def group_body(bps, shared, x):
            for bp in bps:
                x = _ssm_block(cast(bp, dt), x, cfg)
            return _dense_block(shared, x, cfg, positions)
        group_body = _remat(group_body, cfg)
        for group in _groups(cfg, len(params["blocks"])):
            x, kv = group_body([params["blocks"][i] for i in group], shared,
                               x)
            x = constrain(x, "b", None, "m")
            if collect:
                kvs.append(kv)
    else:  # encdec
        enc_out = _encode(params, batch["enc_frames"], cfg, dt)
        x = x + sinusoidal_positions(S, cfg.d_model,
                                     device=x.device).to(dt)[None]
        block = _remat(lambda bp, x, enc_out: _dec_block(
            cast(bp, dt), x, enc_out, cfg, positions), cfg)
        for bp in params["blocks"]:
            x, kv, enc_kv = block(bp, x, enc_out)
            x = constrain(x, "b", None, "m")
            if collect:
                kvs.append(kv)
                enc_kvs.append(enc_kv)
    if last_only:
        x = x[:, -1:]
    x = _final_norm(params, x, cfg)
    logits = constrain((x @ _head(params).to(dt)).float(), "b", None, "m")
    out = {"logits": logits, "aux": aux}
    if mode == "prefill":
        caches = _stacked(kvs) if kvs else None
        out["caches"] = (caches, _stacked(enc_kvs)) if enc_kvs else caches
    return out


def init_caches(cfg: ArchConfig, batch: int, max_seq: int, *,
                cache_dtype: torch.dtype = torch.bfloat16,
                enc_seq: int | None = None, device=None) -> dict:
    """Zeroed decode caches on ``device`` (the current CUDA device unless
    ``device="cpu"`` is given), laid out as the reference's:

    * dense, vlm, moe: ``{"k", "v"}``, (L, B, max_seq, KVH, D) each;
    * ssm: ``{"conv": (L, B, W - 1, d_inner), "state": (L, B, H, N, P)
      float32}``;
    * hybrid: ``{"ssm": <the ssm caches>, "k", "v"}``, the KV caches of
      the shared block with the groups leading;
    * encdec: ``{"k", "v"}`` as dense, ``"cross_k"``, ``"cross_v"``,
      (L, B, enc_seq, KVH, D) each (``enc_seq`` defaults to the
      config's), which the caller fills with the encoder's K/V, and
      ``"enc_len"`` (B,) int32."""
    require_ported(cfg)
    dev = resolve_device(device)

    def kv(n: int, seq: int, prefix: str = "") -> dict:
        shape = (n, batch, seq, cfg.n_kv_heads, cfg.hd)
        return {prefix + "k": torch.zeros(shape, dtype=cache_dtype,
                                          device=dev),
                prefix + "v": torch.zeros(shape, dtype=cache_dtype,
                                          device=dev)}

    if cfg.family in ("dense", "vlm", "moe"):
        return kv(cfg.n_layers, max_seq)
    if cfg.family == "encdec":
        return {**kv(cfg.n_layers, max_seq),
                **kv(cfg.n_layers, enc_seq or cfg.encdec.enc_seq, "cross_"),
                "enc_len": torch.zeros((batch,), dtype=torch.int32,
                                       device=dev)}
    ssm = mamba_cache_init(cfg, batch, cache_dtype, layers=cfg.n_layers,
                           device=dev)
    if cfg.family == "ssm":
        return ssm
    return {"ssm": ssm,
            **kv(cfg.n_layers // cfg.hybrid.attn_every, max_seq)}


def _ssm_decode_layer(bp: dict, x: torch.Tensor, caches: dict, layer: int,
                      cfg: ArchConfig) -> torch.Tensor:
    h = rmsnorm(x, bp["ln1"], cfg.norm_eps)
    cache = {"conv": caches["conv"][layer], "state": caches["state"][layer]}
    return x + mamba_decode_step(bp["mamba"], h, cache, cfg)


def _dense_decode_layer(bp: dict, x: torch.Tensor, cache_k: torch.Tensor,
                        cache_v: torch.Tensor, lengths: torch.Tensor,
                        cfg: ArchConfig) -> torch.Tensor:
    """A dense (or moe: ``moe_ffn`` in place of SwiGLU) layer's step."""
    h = rmsnorm(x, bp["ln1"], cfg.norm_eps)
    h = decode_self_attention(bp["attn"], h, cfg, cache_k=cache_k,
                              cache_v=cache_v, lengths=lengths)
    y = x + h
    hy = rmsnorm(y, bp["ln2"], cfg.norm_eps)[:, None]
    if "moe" in bp:
        ff, _ = moe_ffn(bp["moe"], hy, cfg)
    else:
        ff = swiglu(bp["mlp"], hy)
    return y + ff[:, 0]


def _dec_decode_layer(bp: dict, x: torch.Tensor, caches: dict, layer: int,
                      lengths: torch.Tensor, cfg: ArchConfig,
                      dt: torch.dtype) -> torch.Tensor:
    h = layernorm(x, bp["ln1"], cfg.norm_eps)
    h = decode_self_attention(bp["self_attn"], h, cfg,
                              cache_k=caches["k"][layer],
                              cache_v=caches["v"][layer], lengths=lengths)
    y = x + h
    enc_kv = (caches["cross_k"][layer].to(dt),
              caches["cross_v"][layer].to(dt))
    h = cross_attention(bp["cross_attn"],
                        layernorm(y, bp["ln2"], cfg.norm_eps)[:, None],
                        enc_kv, cfg)
    y = y + h[:, 0]
    ff = gelu_mlp(bp["mlp"], layernorm(y, bp["ln3"], cfg.norm_eps)[:, None])
    return y + ff[:, 0]


def decode_step(params: dict, token: torch.Tensor, caches: dict,
                lengths: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """token (B,) int; lengths (B,) int32 count the tokens, the new one
    included.  Writes each layer's new KV entries, conv window and SSM
    state into ``caches`` in place and returns the logits (B, V)
    float32.  encdec's cross attention reads ``cross_k``/``cross_v`` as
    they are (all ``enc_seq`` positions, as in the reference)."""
    require_ported(cfg)
    dt = DTYPES[cfg.dtype]
    fam = cfg.family
    x = lookup(params["embed"].to(dt), token)  # (B, d)
    blocks = params["blocks"]
    if fam in ("dense", "vlm", "moe"):
        for layer, bp in enumerate(blocks):
            x = _dense_decode_layer(cast(bp, dt), x, caches["k"][layer],
                                    caches["v"][layer], lengths, cfg)
    elif fam == "ssm":
        for layer, bp in enumerate(blocks):
            x = _ssm_decode_layer(cast(bp, dt), x, caches, layer, cfg)
    elif fam == "hybrid":
        shared = cast(params["shared_attn"], dt)
        for g, group in enumerate(_groups(cfg, len(blocks))):
            for layer in group:
                x = _ssm_decode_layer(cast(blocks[layer], dt), x,
                                      caches["ssm"], layer, cfg)
            x = _dense_decode_layer(shared, x, caches["k"][g],
                                    caches["v"][g], lengths, cfg)
    else:  # encdec
        x = x + sinusoidal_at(lengths - 1, cfg.d_model).to(dt)
        for layer, bp in enumerate(blocks):
            x = _dec_decode_layer(cast(bp, dt), x, caches, layer, lengths,
                                  cfg, dt)
    x = _final_norm(params, x, cfg)
    return constrain((x @ _head(params).to(dt)).float(), "b", "m")
