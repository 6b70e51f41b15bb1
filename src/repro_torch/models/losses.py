"""Losses: the twin of ``src/repro/models/losses.py``.

The cross-entropy never holds the (B, L, V) logits at once: the lm-head
product and the log-softmax run per sequence chunk, and each chunk is
rematerialised in the backward (``torch.utils.checkpoint``), so the live
logits are B x chunk x V. The vocabulary is not sharded here (the port is
single-device; sharding is ROADMAP queue 1, item 9).
"""
from __future__ import annotations

import torch

from .common import remat

IGNORE = -100


def _chunk_xent(h_c, w, labels_c, z_loss: float):
    """h_c (B, Lc, D) @ w (D, V) -> this chunk's (sum of losses, count)."""
    logits = h_c.float() @ w.float()
    lse = torch.logsumexp(logits, dim=-1)                       # (B, Lc)
    ll = torch.gather(logits, -1, labels_c.clamp_min(0)[..., None])[..., 0]
    mask = labels_c != IGNORE
    per_tok = lse - ll
    if z_loss:
        per_tok = per_tok + z_loss * lse ** 2
    return torch.where(mask, per_tok, 0.0).sum(), mask.sum()


def chunked_softmax_xent(hidden, w, labels, chunk: int = 512, z_loss: float = 0.0):
    """hidden (B, L, D), w (D, V), labels (B, L) with IGNORE padding. Returns
    the mean loss over the tokens that are not ignored (f32 scalar). The
    chunk is the largest divisor of L not above ``chunk``; chunk losses are
    summed in order, as the reference's scan sums them."""
    L = hidden.shape[1]
    c = min(chunk, L)
    while L % c:
        c -= 1
    body = remat(lambda h_c, w_, l_c: _chunk_xent(h_c, w_, l_c, z_loss), True)
    loss_sum = torch.zeros((), dtype=torch.float32, device=hidden.device)
    n_tok = torch.zeros((), dtype=torch.int64, device=hidden.device)
    for i in range(0, L, c):
        loss, n = body(hidden[:, i:i + c], w, labels[:, i:i + c])
        loss_sum = loss_sum + loss
        n_tok = n_tok + n
    return loss_sum / torch.clamp(n_tok, min=1)


def logits_last(hidden_last: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Final-position logits for serving. hidden_last (B, D) -> (B, V), f32."""
    return hidden_last.float() @ w.float()
