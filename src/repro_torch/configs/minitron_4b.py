"""minitron-4b — pruned Nemotron dense LM [arXiv:2407.14679; hf]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="minitron-4b", family="dense",
    n_layers=32, d_model=3072, n_heads=24, n_kv_heads=8, head_dim=128,
    d_ff=9216, vocab=256000, rope_theta=1e4,
    source="arXiv:2407.14679; hf",
)
