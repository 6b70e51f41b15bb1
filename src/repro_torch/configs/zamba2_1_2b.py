"""zamba2-1.2b [arXiv:2411.15242; hf].

38L d_model=2048 32H (kv=32) d_ff=8192 vocab=32000, ssm_state=64: a Mamba2
backbone plus one shared attention block applied every 6 layers
(per-invocation LoRA deltas omitted, as in the reference's config).
"""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-1.2b", family="hybrid",
    n_layers=38, d_model=2048, n_heads=32, n_kv_heads=32,
    d_ff=8192, vocab=32000, ssm_state=64, attn_every=6,
    ssm_head_dim=64, ssm_expand=2,
    notes="Mamba2 + shared attn block; sub-quadratic -> long_500k runs",
)
