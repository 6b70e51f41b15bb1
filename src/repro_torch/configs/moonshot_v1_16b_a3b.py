"""moonshot-v1-16b-a3b (Moonlight-16B-A3B) [hf:moonshotai/Moonlight-16B-A3B; hf].

48L d_model=2048 16H (GQA kv=16) d_ff=1408 vocab=163840, MoE 64 experts
top-6. The published model also has shared experts and MLA-style
attention; the config pins the fields below, as the reference's does.
"""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="moonshot-v1-16b-a3b", family="moe",
    n_layers=48, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=1408, vocab=163840, n_experts=64, top_k=6,
    rope_theta=50000.0,
    notes="MoE 64e top-6; full attention -> long_500k skipped",
)
