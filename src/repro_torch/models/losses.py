"""The serving half of ``src/repro/models/losses.py``. The chunked
cross-entropy waits for training (ROADMAP queue 1, item 9)."""
from __future__ import annotations

import torch


def logits_last(hidden_last: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Final-position logits for serving. hidden_last (B, D) -> (B, V), f32."""
    return hidden_last.float() @ w.float()
