"""Helpers of the reference's decoder stack (``src/repro/models/
transformer.py``) that the hybrid model uses. The dense, MoE and SSM stacks
themselves are not ported yet (ROADMAP queue 1, item 9)."""
from __future__ import annotations

from . import layers as ly
from . import ssm as ssm_mod
from .config import ArchConfig


def attn_cfg(cfg: ArchConfig) -> ly.AttnCfg:
    return ly.AttnCfg(
        d_model=cfg.d_model, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
        head_dim=cfg.head_dim, qkv_bias=cfg.qkv_bias, qk_norm=cfg.qk_norm,
        window=cfg.window, rope_theta=cfg.rope_theta)


def ssm_cfg(cfg: ArchConfig) -> ssm_mod.SSMCfg:
    return ssm_mod.SSMCfg(
        d_model=cfg.d_model, d_state=cfg.ssm_state, d_conv=cfg.ssm_conv,
        expand=cfg.ssm_expand, head_dim=cfg.ssm_head_dim, n_groups=cfg.ssm_groups)


def head_weight(params, cfg: ArchConfig):
    if cfg.tie_embeddings:
        return params["embed"].T
    return params["lm_head"]
