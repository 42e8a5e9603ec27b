"""zamba2-2.7b — hybrid: Mamba2 backbone + shared attention blocks
[arXiv:2411.15242; hf]."""
from .base import ArchConfig, HybridCfg, SSMCfg

CONFIG = ArchConfig(
    name="zamba2-2.7b", family="hybrid",
    n_layers=54, d_model=2560, n_heads=32, n_kv_heads=32, head_dim=80,
    d_ff=10240, vocab=32000, rope_theta=1e4,
    ssm=SSMCfg(d_state=64, head_dim=64, conv_width=4, expand=2),
    hybrid=HybridCfg(attn_every=6, n_shared_blocks=1),
    source="arXiv:2411.15242; hf",
)
