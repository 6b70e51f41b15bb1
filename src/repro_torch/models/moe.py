"""Mixture-of-Experts layer with capacity-based dispatch (GShard-style): the
twin of ``src/repro/models/moe.py``.

Token routing: a top-k softmax gate (the router in f32 whatever the
parameter dtype), the position of each (token, k) within its expert by an
exclusive cumsum over the row-major (T*K, E) one-hot, a scatter into
per-expert capacity buffers (E, C, D), the stacked-expert SwiGLU as three
batched matrix products, and a gather-combine weighted by the gates that
survive the drop. Overflow past the capacity is dropped, the reference's
rule. Aux: the standard load-balancing loss (Switch/Mixtral).
"""
from __future__ import annotations

import dataclasses

import torch

from . import common as cm


@dataclasses.dataclass(frozen=True)
class MoECfg:
    d_model: int
    d_ff: int               # per-expert hidden
    n_experts: int
    top_k: int
    capacity_factor: float = 1.25
    router_jitter: float = 0.0


def moe_init(gen: torch.Generator, cfg: MoECfg, dtype: torch.dtype):
    E, D, F = cfg.n_experts, cfg.d_model, cfg.d_ff
    sc_in, sc_out = D ** -0.5, F ** -0.5
    return {
        "router": cm.normal(gen, (D, E), sc_in, torch.float32),
        "wg": cm.normal(gen, (E, D, F), sc_in, dtype),
        "wu": cm.normal(gen, (E, D, F), sc_in, dtype),
        "wd": cm.normal(gen, (E, F, D), sc_out, dtype),
    }


def route(p, xt: torch.Tensor, k: int):
    """The gate of tokens ``xt`` (T, D): (probs (T, E) f32, the probabilities
    sorted in descending order (T, E), gate_idx (T, k)). Sorted stably, so a
    tie goes to the lower expert index, as ``jax.lax.top_k`` breaks it."""
    logits = xt.float() @ p["router"].float()
    probs = torch.softmax(logits, dim=-1)
    ranked, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    return probs, ranked, order[:, :k]


def capacity_of(cfg: MoECfg, n_tokens: int) -> int:
    """Slots per expert. The floor keeps tiny decode batches drop-free
    (worst case: all T tokens route their K choices to one expert)."""
    K, E = cfg.top_k, cfg.n_experts
    return int(max(K * cfg.capacity_factor * n_tokens / E, min(n_tokens * K, 8)))


def moe_apply(p, x: torch.Tensor, cfg: MoECfg):
    """x: (B, L, D) -> (out (B, L, D), aux_loss f32 scalar)."""
    B, L, D = x.shape
    E, K = cfg.n_experts, cfg.top_k
    T = B * L
    xt = x.reshape(T, D)

    probs, ranked, gate_idx = route(p, xt, K)
    gate_vals = ranked[:, :K]
    gate_vals = gate_vals / torch.sum(gate_vals, dim=-1, keepdim=True)

    # load-balancing auxiliary loss (mean prob * mean assignment fraction)
    onehot = torch.nn.functional.one_hot(gate_idx, E)                  # (T, K, E)
    assign = onehot.float().sum(1)
    aux = E * torch.mean(probs.mean(0) * assign.mean(0))

    capacity = capacity_of(cfg, T)
    # position of each (token, k) within its expert's buffer
    flatoh = onehot.reshape(T * K, E)
    pos_in_e = torch.cumsum(flatoh, dim=0) - flatoh                     # (T*K, E)
    pos = torch.sum(pos_in_e * flatoh, dim=-1).reshape(T, K)
    keep = pos < capacity                                               # drop overflow
    gate_vals = gate_vals * keep

    # scatter into (E, C, D): a dropped (token, k) adds a zero row to slot
    # capacity - 1, which a kept token may hold, so the scatter accumulates
    e_flat = gate_idx.reshape(-1)
    c_flat = torch.where(keep, pos, capacity - 1).reshape(-1)
    src = xt[:, None, :].expand(T, K, D).reshape(T * K, D)
    src = torch.where(keep.reshape(-1, 1), src, torch.zeros((), dtype=x.dtype,
                                                           device=x.device))
    buf = torch.zeros((E, capacity, D), dtype=x.dtype, device=x.device)
    buf.index_put_((e_flat, c_flat), src, accumulate=True)

    # stacked-expert SwiGLU
    h = cm.swiglu(torch.bmm(buf, p["wg"]), torch.bmm(buf, p["wu"]))
    out_buf = torch.bmm(h, p["wd"])                                     # (E, C, D)

    # gather-combine weighted by the surviving gates
    picked = out_buf[e_flat, c_flat].reshape(T, K, D)
    out = torch.sum(picked * gate_vals[..., None].to(x.dtype), dim=1)
    return out.reshape(B, L, D), aux
