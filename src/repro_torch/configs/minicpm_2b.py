"""minicpm-2b [arXiv:2404.06395; hf].

40L d_model=2304 36H (kv=36) d_ff=5760 vocab=122753: a llama-like stack
with tied embeddings (trained with the WSD schedule; training is not
ported yet).
"""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="minicpm-2b", family="dense",
    n_layers=40, d_model=2304, n_heads=36, n_kv_heads=36,
    d_ff=5760, vocab=122753, tie_embeddings=True,
    notes="WSD schedule; full attention -> long_500k skipped",
)
