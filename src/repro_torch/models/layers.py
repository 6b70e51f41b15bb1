"""Attention (GQA, qk-norm, QKV bias, sliding window, RoPE), MLP and norm
blocks: the twins of ``src/repro/models/layers.py``.

Every ``*_init`` returns a dict of tensors in the reference's layout and
draws from an explicit ``torch.Generator``; every ``*_apply`` is a function
of (params, activations). Weight layout is the reference's: ``x @ w`` with
w of shape (in, out).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from . import common as cm
from ..kernels import ops


@dataclasses.dataclass(frozen=True)
class AttnCfg:
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    qkv_bias: bool = False
    qk_norm: bool = False
    window: Optional[int] = None
    rope_theta: float = 10000.0
    causal: bool = True


def attn_init(gen: torch.Generator, cfg: AttnCfg, dtype: torch.dtype):
    D, H, Hkv, Dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    sc = D ** -0.5
    dev = gen.device
    p = {
        "wq": cm.normal(gen, (D, H * Dh), sc, dtype),
        "wk": cm.normal(gen, (D, Hkv * Dh), sc, dtype),
        "wv": cm.normal(gen, (D, Hkv * Dh), sc, dtype),
        "wo": cm.normal(gen, (H * Dh, D), (H * Dh) ** -0.5, dtype),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((H * Dh,), dtype=dtype, device=dev)
        p["bk"] = torch.zeros((Hkv * Dh,), dtype=dtype, device=dev)
        p["bv"] = torch.zeros((Hkv * Dh,), dtype=dtype, device=dev)
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((Dh,), dtype=dtype, device=dev)
        p["k_norm"] = torch.ones((Dh,), dtype=dtype, device=dev)
    return p


def _project_qkv(p, x, cfg: AttnCfg, positions):
    B, L, _ = x.shape
    H, Hkv, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q, k, v = x @ p["wq"], x @ p["wk"], x @ p["wv"]
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(B, L, H, Dh)
    k = k.reshape(B, L, Hkv, Dh)
    v = v.reshape(B, L, Hkv, Dh)
    if "q_norm" in p:
        q = cm.rms_norm(q, p["q_norm"])
        k = cm.rms_norm(k, p["k_norm"])
    q = cm.apply_rope(q.transpose(1, 2), positions[:, None, :], cfg.rope_theta)
    k = cm.apply_rope(k.transpose(1, 2), positions[:, None, :], cfg.rope_theta)
    # (B, H, L, Dh) / (B, Hkv, L, Dh), contiguous for the kernel
    return q.contiguous(), k.contiguous(), v.transpose(1, 2).contiguous()


def attn_apply(p, x, cfg: AttnCfg, positions=None, attn_impl: str = "cuda"):
    """Self-attention over the full sequence (prefill). Returns
    (out (B, L, D), (k, v)), k/v (B, Hkv, L, Dh) for the cache."""
    B, L, _ = x.shape
    if positions is None:
        positions = torch.arange(L, device=x.device).expand(B, L)
    q, k, v = _project_qkv(p, x, cfg, positions)
    out = ops.attention(q, k, v, causal=cfg.causal, window=cfg.window, impl=attn_impl)
    out = out.transpose(1, 2).reshape(B, L, cfg.n_heads * cfg.head_dim)
    return out @ p["wo"], (k, v)


def attn_decode(p, x, cfg: AttnCfg, k_cache, v_cache, pos: int):
    """One-token decode. x (B, 1, D); caches (B, Hkv, S, Dh); pos: the
    token's index. Writes the token's k and v into the caches at ``pos``
    in place and returns (out (B, 1, D), (k_cache, v_cache))."""
    B = x.shape[0]
    positions = torch.full((B, 1), int(pos), dtype=torch.int64, device=x.device)
    q, k, v = _project_qkv(p, x, cfg, positions)
    k_cache[:, :, pos] = k[:, :, 0]
    v_cache[:, :, pos] = v[:, :, 0]
    out = ops.decode_attention(q[:, :, 0], k_cache, v_cache, pos=pos, window=cfg.window)
    out = out.reshape(B, 1, cfg.n_heads * cfg.head_dim)
    return out @ p["wo"], (k_cache, v_cache)


# --- MLP ---------------------------------------------------------------------
def mlp_init(gen: torch.Generator, d_model: int, d_ff: int, dtype: torch.dtype):
    sc_in, sc_out = d_model ** -0.5, d_ff ** -0.5
    return {
        "wg": cm.normal(gen, (d_model, d_ff), sc_in, dtype),
        "wu": cm.normal(gen, (d_model, d_ff), sc_in, dtype),
        "wd": cm.normal(gen, (d_ff, d_model), sc_out, dtype),
    }


def mlp_apply(p, x):
    return cm.swiglu(x @ p["wg"], x @ p["wu"]) @ p["wd"]


# --- norms --------------------------------------------------------------------
def norm_init(d: int, dtype: torch.dtype, device):
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def norm_apply(p, x, eps: float = 1e-6):
    return cm.rms_norm(x, p["scale"], eps)
