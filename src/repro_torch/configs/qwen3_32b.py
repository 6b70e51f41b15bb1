"""qwen3-32b [hf:Qwen/Qwen3-8B; hf].

64L d_model=5120 64H (GQA kv=8) d_ff=25600 vocab=151936, qk_norm.
"""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-32b", family="dense",
    n_layers=64, d_model=5120, n_heads=64, n_kv_heads=8,
    d_ff=25600, vocab=151936, qk_norm=True, head_dim=128,
    rope_theta=1e6,
    notes="qk_norm + GQA; full attention -> long_500k skipped",
)
