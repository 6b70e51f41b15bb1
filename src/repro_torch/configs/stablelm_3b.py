"""stablelm-3b [hf:stabilityai/stablelm-2-1_6b; unverified].

32L d_model=2560 32H (kv=32) d_ff=6912 vocab=50304.
"""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="stablelm-3b", family="dense",
    n_layers=32, d_model=2560, n_heads=32, n_kv_heads=32,
    d_ff=6912, vocab=50304,
    notes="full attention -> long_500k skipped",
)
