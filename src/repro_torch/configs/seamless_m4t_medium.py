"""seamless-m4t-medium [arXiv:2308.11596; hf].

12L d_model=1024 16H (kv=16) d_ff=4096 vocab=256206: an encoder-decoder of
12 encoder and 12 decoder layers. The frame frontend is a stub: a prefill
batch carries precomputed frame embeddings (source_len, d_model); decode
steps the decoder against its self-attention and cross-attention caches.
"""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="seamless-m4t-medium", family="encdec",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=4096, vocab=256206, n_enc_layers=12, n_dec_layers=12,
    source_len=1024,
    notes="enc-dec; frontend stub; full attention -> long_500k skipped",
)
