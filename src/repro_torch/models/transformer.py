"""Decoder-only LM stack (dense / MoE / VLM backbone / pure-SSM families):
the serving half of ``src/repro/models/transformer.py``.

Parameters keep the reference's stacked (scan) layout: every leaf of
``blocks`` carries a leading layer axis, and the forward pass is a Python
loop over the layers. Attention blocks launch the attention kernel in
prefill and training; the SSM family's blocks (``models/ssm.py``) launch
conv1d and SSD. Decode runs plain PyTorch, as the reference does outside
its kernels, and updates the cache in place. ``loss_fn`` is the training
loss: the chunked cross-entropy plus ``AUX_COEF`` times the MoE's
load-balancing loss, with each block rematerialised under ``rc.remat``.
"""
from __future__ import annotations

import torch

from . import common as cm
from . import layers as ly
from . import losses as lo
from . import moe as moe_mod
from . import ssm as ssm_mod
from .config import ArchConfig, RunConfig

AUX_COEF = 0.01


def attn_cfg(cfg: ArchConfig) -> ly.AttnCfg:
    return ly.AttnCfg(
        d_model=cfg.d_model, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
        head_dim=cfg.head_dim, qkv_bias=cfg.qkv_bias, qk_norm=cfg.qk_norm,
        window=cfg.window, rope_theta=cfg.rope_theta)


def ssm_cfg(cfg: ArchConfig) -> ssm_mod.SSMCfg:
    return ssm_mod.SSMCfg(
        d_model=cfg.d_model, d_state=cfg.ssm_state, d_conv=cfg.ssm_conv,
        expand=cfg.ssm_expand, head_dim=cfg.ssm_head_dim, n_groups=cfg.ssm_groups)


def moe_cfg(cfg: ArchConfig, rc: RunConfig) -> moe_mod.MoECfg:
    return moe_mod.MoECfg(
        d_model=cfg.d_model, d_ff=cfg.d_ff, n_experts=cfg.n_experts,
        top_k=cfg.top_k, capacity_factor=rc.capacity_factor)


def block_kind(cfg: ArchConfig) -> str:
    if cfg.family == "ssm":
        return "ssm"
    if cfg.is_moe:
        return "attn_moe"
    return "attn_mlp"


def head_weight(params, cfg: ArchConfig):
    if cfg.tie_embeddings:
        return params["embed"].T
    return params["lm_head"]


def param_dtype(rc: RunConfig) -> torch.dtype:
    return getattr(torch, rc.param_dtype)


# --------------------------------------------------------------------------
# init
# --------------------------------------------------------------------------
def block_init(gen: torch.Generator, cfg: ArchConfig, rc: RunConfig, dtype):
    dev = gen.device
    kind = block_kind(cfg)
    if kind == "ssm":
        return {"norm": ly.norm_init(cfg.d_model, dtype, dev),
                "ssm": ssm_mod.ssm_init(gen, ssm_cfg(cfg), dtype)}
    p = {"attn_norm": ly.norm_init(cfg.d_model, dtype, dev),
         "attn": ly.attn_init(gen, attn_cfg(cfg), dtype),
         "mlp_norm": ly.norm_init(cfg.d_model, dtype, dev)}
    if kind == "attn_moe":
        p["moe"] = moe_mod.moe_init(gen, moe_cfg(cfg, rc), dtype)
    else:
        p["mlp"] = ly.mlp_init(gen, cfg.d_model, cfg.d_ff, dtype)
    return p


def model_init(gen: torch.Generator, cfg: ArchConfig, rc: RunConfig):
    """Parameters on ``gen``'s device, drawn from ``gen`` with the
    reference's distributions."""
    dtype, dev = param_dtype(rc), gen.device
    tree = {
        "embed": cm.normal(gen, (cfg.vocab, cfg.d_model), 0.02, dtype),
        "blocks": cm.stack_layers(cfg.n_layers, lambda: block_init(gen, cfg, rc, dtype)),
        "norm_f": ly.norm_init(cfg.d_model, dtype, dev),
    }
    if not cfg.tie_embeddings:
        tree["lm_head"] = cm.normal(gen, (cfg.d_model, cfg.vocab), cfg.d_model ** -0.5,
                                    dtype)
    return tree


# --------------------------------------------------------------------------
# forward
# --------------------------------------------------------------------------
def _mlp_or_moe(bp, hn, cfg: ArchConfig, rc: RunConfig):
    if "moe" in bp:
        return moe_mod.moe_apply(bp["moe"], hn, moe_cfg(cfg, rc))
    return ly.mlp_apply(bp["mlp"], hn), torch.zeros((), device=hn.device)


def block_apply(bp, h, cfg: ArchConfig, rc: RunConfig, positions):
    """One block over the full sequence -> (h, aux), aux the MoE
    load-balancing loss (0 for the other kinds)."""
    if block_kind(cfg) == "ssm":
        hn = ly.norm_apply(bp["norm"], h, cfg.norm_eps)
        out, _ = ssm_mod.ssm_apply(bp["ssm"], hn, ssm_cfg(cfg), ssd_impl=rc.ssd_impl,
                                   conv_impl=rc.conv_impl)
        return h + out, torch.zeros((), device=h.device)
    a_in = ly.norm_apply(bp["attn_norm"], h, cfg.norm_eps)
    a, _ = ly.attn_apply(bp["attn"], a_in, attn_cfg(cfg), positions, attn_impl=rc.attn_impl)
    h = h + a
    m, aux = _mlp_or_moe(bp, ly.norm_apply(bp["mlp_norm"], h, cfg.norm_eps), cfg, rc)
    return h + m, aux


def forward_hidden(params, cfg: ArchConfig, rc: RunConfig, embeds, positions=None):
    """embeds (B, L, D) -> (final-normed hidden (B, L, D), mean aux); each
    block rematerialised in the backward under ``rc.remat``."""
    B, L, _ = embeds.shape
    if positions is None:
        positions = torch.arange(L, device=embeds.device).expand(B, L)
    body = cm.remat(lambda bp, h: block_apply(bp, h, cfg, rc, positions), rc.remat,
                    rc.remat_policy)
    h, auxs = embeds, []
    for bp in cm.unstack(params["blocks"], cfg.n_layers):
        h, aux = body(bp, h)
        auxs.append(aux)
    h = ly.norm_apply(params["norm_f"], h, cfg.norm_eps)
    return h, torch.stack(auxs).mean()


def embed_tokens(params, cfg: ArchConfig, tokens, prefix_embeds=None):
    emb = params["embed"][tokens]
    if prefix_embeds is not None:  # VLM / audio stub frontends
        emb = torch.cat([prefix_embeds.to(emb.dtype), emb], dim=1)
    return emb


def loss_fn(params, cfg: ArchConfig, rc: RunConfig, tokens, labels, prefix_embeds=None):
    """tokens (B, L) int; labels (B, L) with ``losses.IGNORE`` padding; a
    VLM's patch embeddings (B, n, D) come first, their labels ignored."""
    emb = embed_tokens(params, cfg, tokens, prefix_embeds)
    if prefix_embeds is not None:
        pad = torch.full(prefix_embeds.shape[:2], lo.IGNORE, dtype=labels.dtype,
                         device=labels.device)
        labels = torch.cat([pad, labels], dim=1)
    h, aux = forward_hidden(params, cfg, rc, emb)
    loss = lo.chunked_softmax_xent(h, head_weight(params, cfg), labels,
                                   chunk=rc.loss_chunk, z_loss=rc.z_loss)
    if cfg.is_moe:
        loss = loss + AUX_COEF * aux
    return loss


# --------------------------------------------------------------------------
# serving: prefill + decode
# --------------------------------------------------------------------------
def init_cache(cfg: ArchConfig, rc: RunConfig, batch: int, max_seq: int, device,
               dtype=None):
    dtype = param_dtype(rc) if dtype is None else dtype
    Ln = cfg.n_layers
    if block_kind(cfg) == "ssm":
        sc = ssm_cfg(cfg)
        return {
            "conv": torch.zeros((Ln, batch, sc.d_conv - 1, sc.d_conv_in), dtype=dtype,
                                device=device),
            "ssm": torch.zeros((Ln, batch, sc.n_heads, sc.head_dim, sc.d_state),
                               dtype=torch.float32, device=device),
        }
    kv = (Ln, batch, cfg.n_kv_heads, max_seq, cfg.head_dim)
    return {"k": torch.zeros(kv, dtype=dtype, device=device),
            "v": torch.zeros(kv, dtype=dtype, device=device)}


def prefill(params, cfg: ArchConfig, rc: RunConfig, tokens, max_seq: int,
            prefix_embeds=None):
    """Full-sequence pass -> (last-position logits (B, V) f32, cache). The
    K/V of each layer are written into a cache of ``max_seq`` positions
    (zeros past the prompt, as the reference pads them)."""
    h = embed_tokens(params, cfg, tokens, prefix_embeds)
    B, L, _ = h.shape
    if L > max_seq:
        raise ValueError(f"prompt of {L} positions exceeds max_seq={max_seq}")
    positions = torch.arange(L, device=h.device).expand(B, L)
    cache = init_cache(cfg, rc, B, max_seq, h.device)
    for i in range(cfg.n_layers):
        bp = cm.layer(params["blocks"], i)
        if block_kind(cfg) == "ssm":
            hn = ly.norm_apply(bp["norm"], h, cfg.norm_eps)
            out, st = ssm_mod.ssm_apply(bp["ssm"], hn, ssm_cfg(cfg), ssd_impl=rc.ssd_impl,
                                        conv_impl=rc.conv_impl, return_state=True)
            h = h + out
            cache["conv"][i] = st["conv"]
            cache["ssm"][i] = st["ssm"]
            continue
        a_in = ly.norm_apply(bp["attn_norm"], h, cfg.norm_eps)
        a, (k, v) = ly.attn_apply(bp["attn"], a_in, attn_cfg(cfg), positions,
                                  attn_impl=rc.attn_impl)
        h = h + a
        m, _ = _mlp_or_moe(bp, ly.norm_apply(bp["mlp_norm"], h, cfg.norm_eps), cfg, rc)
        h = h + m
        cache["k"][i, :, :, :L] = k
        cache["v"][i, :, :, :L] = v
    h = ly.norm_apply(params["norm_f"], h, cfg.norm_eps)
    return lo.logits_last(h[:, -1], head_weight(params, cfg)), cache


def decode_step(params, cfg: ArchConfig, rc: RunConfig, token, cache, pos):
    """token (B,) at index ``pos`` -> (logits (B, V) f32, cache). The cache
    is updated in place (the reference returns new arrays) and returned."""
    pos = int(pos)
    h = params["embed"][token[:, None]]
    for i in range(cfg.n_layers):
        bp = cm.layer(params["blocks"], i)
        if block_kind(cfg) == "ssm":
            hn = ly.norm_apply(bp["norm"], h, cfg.norm_eps)
            out, st = ssm_mod.ssm_decode(bp["ssm"], hn, ssm_cfg(cfg),
                                         {"conv": cache["conv"][i], "ssm": cache["ssm"][i]})
            h = h + out
            cache["conv"][i] = st["conv"]
            cache["ssm"][i] = st["ssm"]
            continue
        a_in = ly.norm_apply(bp["attn_norm"], h, cfg.norm_eps)
        a, _ = ly.attn_decode(bp["attn"], a_in, attn_cfg(cfg), cache["k"][i],
                              cache["v"][i], pos)
        h = h + a
        m, _ = _mlp_or_moe(bp, ly.norm_apply(bp["mlp_norm"], h, cfg.norm_eps), cfg, rc)
        h = h + m
    h = ly.norm_apply(params["norm_f"], h, cfg.norm_eps)
    return lo.logits_last(h[:, -1], head_weight(params, cfg)), cache
