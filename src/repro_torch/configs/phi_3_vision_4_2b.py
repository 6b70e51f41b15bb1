"""phi-3-vision-4.2b [hf:microsoft/Phi-3-vision-128k-instruct; hf].

32L d_model=3072 32H (kv=32) d_ff=8192 vocab=32064: the phi3-mini backbone
behind a CLIP frontend. The frontend is a stub: a prefill batch carries
precomputed patch embeddings (n_patches, d_model) ahead of its tokens.
"""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="phi-3-vision-4.2b", family="vlm",
    n_layers=32, d_model=3072, n_heads=32, n_kv_heads=32,
    d_ff=8192, vocab=32064, n_patches=576, rope_theta=10000.0,
    notes="VLM backbone; patch embeds stubbed; full attention -> long_500k skipped",
)
