"""mixtral-8x7b — MoE 8 experts top-2, sliding-window attention
[arXiv:2401.04088; hf]."""
from .base import ArchConfig, MoECfg

CONFIG = ArchConfig(
    name="mixtral-8x7b", family="moe",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=14336, vocab=32000, window=4096, rope_theta=1e6,
    moe=MoECfg(n_experts=8, top_k=2, d_ff_expert=14336),
    source="arXiv:2401.04088; hf",
)
