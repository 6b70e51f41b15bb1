"""mamba2-130m [arXiv:2405.21060; unverified].

24L d_model=768 attention-free, vocab=50280, ssm_state=128 (SSD). Its
prefill runs the causal depthwise conv1d and the SSD scan kernels.
"""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-130m", family="ssm",
    n_layers=24, d_model=768, n_heads=24, n_kv_heads=24,
    d_ff=0, vocab=50280, ssm_state=128, ssm_head_dim=64, ssm_expand=2,
    tie_embeddings=True,
    notes="SSD; attention-free; long_500k runs",
)
