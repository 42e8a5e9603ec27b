"""mamba2-130m — attention-free SSM (state-space duality)
[arXiv:2405.21060; unverified]."""
from .base import ArchConfig, SSMCfg

CONFIG = ArchConfig(
    name="mamba2-130m", family="ssm",
    n_layers=24, d_model=768, n_heads=0, n_kv_heads=0, head_dim=64,
    d_ff=0, vocab=50280, tie_embeddings=True,
    ssm=SSMCfg(d_state=128, head_dim=64, conv_width=4, expand=2),
    source="arXiv:2405.21060; unverified",
)
