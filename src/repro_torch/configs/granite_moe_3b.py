"""granite-moe-3b-a800m — MoE, 40 experts top-8 (assignment config field;
the comment's '32 experts' conflicts and is noted in DESIGN.md)
[hf:ibm-granite/granite-3.0-1b-a400m-base; hf]."""
from .base import ArchConfig, MoECfg

CONFIG = ArchConfig(
    name="granite-moe-3b-a800m", family="moe",
    n_layers=32, d_model=1536, n_heads=24, n_kv_heads=8, head_dim=64,
    d_ff=512, vocab=49155, rope_theta=1e4,
    moe=MoECfg(n_experts=40, top_k=8, d_ff_expert=512),
    source="hf:ibm-granite/granite-3.0-1b-a400m-base; hf",
)
