"""qwen2-vl-72b — VLM transformer backbone with M-RoPE; vision frontend is
a STUB (input_specs provides patch embeddings + 3-component positions)
[arXiv:2409.12191; hf]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-vl-72b", family="vlm",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=29568, vocab=152064, rope_theta=1e6,
    mrope_sections=(16, 24, 24),
    source="arXiv:2409.12191; hf",
)
