"""whisper-small — audio enc-dec transformer backbone; the conv frontend is
a STUB per the assignment (input_specs provides precomputed frame
embeddings) [arXiv:2212.04356; unverified]."""
from .base import ArchConfig, EncDecCfg

CONFIG = ArchConfig(
    name="whisper-small", family="encdec",
    n_layers=12, d_model=768, n_heads=12, n_kv_heads=12, head_dim=64,
    d_ff=3072, vocab=51865, rope_theta=1e4,
    encdec=EncDecCfg(n_enc_layers=12, enc_seq=1536),
    source="arXiv:2212.04356; unverified",
)
