"""--arch id -> ArchConfig registry + reduced smoke variants."""
from __future__ import annotations

import dataclasses

from .base import SHAPES, ArchConfig, EncDecCfg, MoECfg, SSMCfg
from .granite_moe_3b import CONFIG as granite_moe_3b
from .mamba2_130m import CONFIG as mamba2_130m
from .minitron_4b import CONFIG as minitron_4b
from .mistral_large_123b import CONFIG as mistral_large_123b
from .mixtral_8x7b import CONFIG as mixtral_8x7b
from .phi3_medium_14b import CONFIG as phi3_medium_14b
from .qwen2_vl_72b import CONFIG as qwen2_vl_72b
from .qwen3_0_6b import CONFIG as qwen3_0_6b
from .whisper_small import CONFIG as whisper_small
from .zamba2_2_7b import CONFIG as zamba2_2_7b

ARCHS: dict[str, ArchConfig] = {
    c.name: c
    for c in [
        minitron_4b, mistral_large_123b, qwen3_0_6b, phi3_medium_14b,
        whisper_small, granite_moe_3b, mixtral_8x7b, qwen2_vl_72b,
        zamba2_2_7b, mamba2_130m,
    ]
}


def get_arch(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; have {sorted(ARCHS)}")
    return ARCHS[name]


def smoke(cfg: ArchConfig) -> ArchConfig:
    """Reduced same-family config: small widths/depths/tables, one CPU
    forward/train step in tests.  Full configs only ever meet
    ShapeDtypeStructs (the dry-run)."""
    kw: dict = dict(
        n_layers=2 if cfg.hybrid is None else 2 * cfg.hybrid.attn_every,
        d_model=64,
        vocab=128,
        dtype="float32",
        attn_impl="reference",
        remat="none",
    )
    if cfg.n_heads:
        kw.update(n_heads=4, n_kv_heads=max(1, 4 * cfg.n_kv_heads // max(cfg.n_heads, 1)) if cfg.n_kv_heads < cfg.n_heads else 4, head_dim=16)
    if cfg.d_ff:
        kw.update(d_ff=128)
    if cfg.moe is not None:
        kw.update(moe=MoECfg(n_experts=4, top_k=2, d_ff_expert=64))
    if cfg.ssm is not None:
        kw.update(ssm=SSMCfg(d_state=16, head_dim=16, conv_width=4, expand=2), ssd_chunk=16)
    if cfg.hybrid is not None:
        kw.update(hybrid=dataclasses.replace(cfg.hybrid, attn_every=cfg.hybrid.attn_every))
        kw["hybrid"] = dataclasses.replace(kw["hybrid"], attn_every=2)
        kw["n_layers"] = 4
    if cfg.encdec is not None:
        kw.update(encdec=EncDecCfg(n_enc_layers=2, enc_seq=32))
    if cfg.window is not None:
        kw.update(window=16)
    if cfg.mrope_sections is not None:
        kw.update(mrope_sections=(2, 3, 3))  # sums to head_dim // 2 = 8
    return cfg.replace(**kw)


__all__ = ["ARCHS", "SHAPES", "get_arch", "smoke"]
