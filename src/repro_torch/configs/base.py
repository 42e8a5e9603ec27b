"""Architecture + run configuration.

One :class:`ArchConfig` per assigned architecture lives in
``repro_torch.configs.<id>``; ``repro_torch.configs.registry`` maps ``--arch`` ids to
them.  ``smoke()`` returns a reduced same-family variant for CPU tests.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional


@dataclass(frozen=True)
class MoECfg:
    n_experts: int
    top_k: int
    d_ff_expert: int
    capacity_factor: float = 1.25


@dataclass(frozen=True)
class SSMCfg:
    d_state: int
    head_dim: int = 64
    conv_width: int = 4
    expand: int = 2

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclass(frozen=True)
class HybridCfg:
    attn_every: int  # one shared attention block per this many ssm layers
    n_shared_blocks: int = 1  # distinct shared-weight attention blocks


@dataclass(frozen=True)
class EncDecCfg:
    n_enc_layers: int
    enc_seq: int  # stub-frontend sequence length (e.g. audio frames)


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None  # default d_model // n_heads
    qk_norm: bool = False
    window: Optional[int] = None  # sliding-window attention
    rope_theta: float = 1e4
    mrope_sections: Optional[tuple[int, ...]] = None  # qwen2-vl M-RoPE
    tie_embeddings: bool = False
    moe: Optional[MoECfg] = None
    ssm: Optional[SSMCfg] = None
    hybrid: Optional[HybridCfg] = None
    encdec: Optional[EncDecCfg] = None
    norm_eps: float = 1e-5
    # runtime knobs
    dtype: str = "bfloat16"
    attn_impl: str = "chunked"
    attn_chunk: int = 1024
    ssd_chunk: int = 256
    remat: str = "full"  # full | dots | none
    unroll: bool = False  # unroll scans (cost-analysis dry-runs only)
    # §Perf knobs (baseline = off; see EXPERIMENTS.md §Perf)
    cast_once: bool = False  # cast params to bf16 BEFORE the layer scan so
    #   FSDP all-gathers move bf16, not f32 masters (halves gather bytes)
    parallelism: str = "fsdp_tp"  # or "fsdp_only": no tensor parallelism,
    #   model axis joins data parallelism (right choice for small models
    #   whose TP activation collectives dwarf their matmuls)
    source: str = ""  # provenance tag from the assignment

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def subquadratic(self) -> bool:
        """Can this arch decode at 500k context?  SSM/hybrid are O(1)-state;
        SWA bounds the KV window."""
        return self.family in ("ssm", "hybrid") or self.window is not None

    @property
    def has_decoder(self) -> bool:
        return True  # all assigned archs decode (whisper has a decoder)

    def n_params(self) -> int:
        """Approximate parameter count (for 6ND roofline maths)."""
        d, hd = self.d_model, self.hd
        attn = d * hd * self.n_heads + 2 * d * hd * self.n_kv_heads + hd * self.n_heads * d
        if self.family == "ssm":
            s = self.ssm
            di = s.d_inner(d)
            per = d * (2 * di + 2 * s.d_state + s.n_heads(d)) + di * d + di * s.conv_width
            return self.n_layers * per + self.vocab * d
        mlp = 3 * d * self.d_ff
        if self.moe is not None:
            mlp = self.moe.n_experts * 3 * d * self.moe.d_ff_expert + d * self.moe.n_experts
        per = attn + mlp
        if self.family == "hybrid":
            s = self.ssm
            di = s.d_inner(d)
            ssm_per = d * (2 * di + 2 * s.d_state + s.n_heads(d)) + di * d + di * s.conv_width
            n_attn = self.n_layers // self.hybrid.attn_every
            return (self.n_layers * ssm_per + self.hybrid.n_shared_blocks * per
                    + self.vocab * d)
        n = self.n_layers * per
        if self.encdec is not None:
            # decoder layers add a cross-attention block
            n += self.encdec.n_enc_layers * per + self.n_layers * attn
        n += self.vocab * d * (1 if self.tie_embeddings else 2)
        return n

    def n_active_params(self) -> int:
        """Active parameters per token (MoE uses top_k of n_experts)."""
        if self.moe is None:
            return self.n_params()
        d = self.d_model
        attn = d * self.hd * self.n_heads + 2 * d * self.hd * self.n_kv_heads \
            + self.hd * self.n_heads * d
        mlp = self.moe.top_k * 3 * d * self.moe.d_ff_expert + d * self.moe.n_experts
        return self.n_layers * (attn + mlp) + self.vocab * d * 2

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class ShapeCfg:
    """One assigned input-shape cell."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode

    @property
    def is_train(self) -> bool:
        return self.kind == "train"


SHAPES = {
    "train_4k": ShapeCfg("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCfg("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCfg("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCfg("long_500k", 524288, 1, "decode"),
}
