"""Zamba2-style hybrid: a Mamba2 backbone plus ONE shared attention block,
the twin of ``src/repro/models/hybrid.py`` (serving: init, cache, prefill,
decode).

The shared block (attention and MLP with their own norms) is applied after
every ``attn_every`` Mamba2 layers, with the same parameters at each
application. The tree keeps the reference's layout: the Mamba2 leaves are
stacked (n_groups, attn_every, ...), the ``rem = n_layers % attn_every``
layers after the last group in ``mamba_tail`` (rem, ...), and the shared
block is held once. ``forward_hidden`` and ``loss_fn`` train it: each
Mamba2 layer is rematerialised under ``rc.remat`` (the shared block is not,
as in the reference), and the shared block's gradients accumulate over its
applications.
"""
from __future__ import annotations

import torch

from . import common as cm
from . import layers as ly
from . import losses as lo
from . import ssm as ssm_mod
from .config import ArchConfig, RunConfig
from .transformer import attn_cfg, head_weight, param_dtype, ssm_cfg


def _group_layout(cfg: ArchConfig) -> tuple[int, int, int]:
    k = max(cfg.attn_every, 1)
    n_groups, rem = divmod(cfg.n_layers, k)
    return n_groups, k, rem


def model_init(gen: torch.Generator, cfg: ArchConfig, rc: RunConfig):
    """Parameters on ``gen``'s device, drawn from ``gen`` with the
    reference's distributions."""
    dtype, dev = param_dtype(rc), gen.device
    n_groups, k, rem = _group_layout(cfg)

    def mamba_layer():
        return {"norm": ly.norm_init(cfg.d_model, dtype, dev),
                "ssm": ssm_mod.ssm_init(gen, ssm_cfg(cfg), dtype)}

    tree = {
        "embed": cm.normal(gen, (cfg.vocab, cfg.d_model), 0.02, dtype),
        "mamba": cm.stack_layers(n_groups, lambda: cm.stack_layers(k, mamba_layer)),
        "shared": {
            "attn_norm": ly.norm_init(cfg.d_model, dtype, dev),
            "attn": ly.attn_init(gen, attn_cfg(cfg), dtype),
            "mlp_norm": ly.norm_init(cfg.d_model, dtype, dev),
            "mlp": ly.mlp_init(gen, cfg.d_model, cfg.d_ff, dtype),
        },
        "norm_f": ly.norm_init(cfg.d_model, dtype, dev),
    }
    if rem:
        tree["mamba_tail"] = cm.stack_layers(rem, mamba_layer)
    if not cfg.tie_embeddings:
        tree["lm_head"] = cm.normal(gen, (cfg.d_model, cfg.vocab), cfg.d_model ** -0.5,
                                    dtype)
    return tree


def init_cache(cfg: ArchConfig, rc: RunConfig, batch: int, max_seq: int, device,
               dtype=None):
    dtype = param_dtype(rc) if dtype is None else dtype
    n_groups, _, _ = _group_layout(cfg)
    sc = ssm_cfg(cfg)
    Ln = cfg.n_layers

    def zeros(shape, dt):
        return torch.zeros(shape, dtype=dt, device=device)

    kv = (n_groups, batch, cfg.n_kv_heads, max_seq, cfg.head_dim)
    return {
        "conv": zeros((Ln, batch, sc.d_conv - 1, sc.d_conv_in), dtype),
        "ssm": zeros((Ln, batch, sc.n_heads, sc.head_dim, sc.d_state), torch.float32),
        # shared attention block: one KV cache per *application* (n_groups)
        "k": zeros(kv, dtype),
        "v": zeros(kv, dtype),
    }


def _shared_block(sp, h, cfg, rc, positions):
    a_in = ly.norm_apply(sp["attn_norm"], h, cfg.norm_eps)
    a, kv = ly.attn_apply(sp["attn"], a_in, attn_cfg(cfg), positions, attn_impl=rc.attn_impl)
    h = h + a
    h = h + ly.mlp_apply(sp["mlp"], ly.norm_apply(sp["mlp_norm"], h, cfg.norm_eps))
    return h, kv


def _mamba_layer(bp, h, cfg: ArchConfig, rc: RunConfig):
    hn = ly.norm_apply(bp["norm"], h, cfg.norm_eps)
    out, _ = ssm_mod.ssm_apply(bp["ssm"], hn, ssm_cfg(cfg), ssd_impl=rc.ssd_impl,
                               conv_impl=rc.conv_impl)
    return h + out


def forward_hidden(params, cfg: ArchConfig, rc: RunConfig, embeds, positions=None):
    """embeds (B, L, D) -> (final-normed hidden (B, L, D), 0 aux)."""
    B, L, _ = embeds.shape
    if positions is None:
        positions = torch.arange(L, device=embeds.device).expand(B, L)
    n_groups, k, rem = _group_layout(cfg)
    body = cm.remat(lambda bp, h: _mamba_layer(bp, h, cfg, rc), rc.remat, rc.remat_policy)
    h = embeds
    for gp in cm.unstack(params["mamba"], n_groups):
        for bp in cm.unstack(gp, k):
            h = body(bp, h)
        h, _ = _shared_block(params["shared"], h, cfg, rc, positions)
    if rem:
        for bp in cm.unstack(params["mamba_tail"], rem):
            h = body(bp, h)
    h = ly.norm_apply(params["norm_f"], h, cfg.norm_eps)
    return h, torch.zeros((), device=h.device)


def loss_fn(params, cfg: ArchConfig, rc: RunConfig, tokens, labels):
    """tokens (B, L) int; labels (B, L) with ``losses.IGNORE`` padding."""
    h, _ = forward_hidden(params, cfg, rc, params["embed"][tokens])
    return lo.chunked_softmax_xent(h, head_weight(params, cfg), labels,
                                   chunk=rc.loss_chunk, z_loss=rc.z_loss)


def prefill(params, cfg: ArchConfig, rc: RunConfig, tokens, max_seq: int):
    """tokens (B, L) -> (logits (B, V) f32 of the last position, cache)."""
    h = params["embed"][tokens]
    B, L, _ = h.shape
    if L > max_seq:
        raise ValueError(f"prompt of {L} tokens exceeds max_seq={max_seq}")
    positions = torch.arange(L, device=h.device).expand(B, L)
    n_groups, k, rem = _group_layout(cfg)
    sc = ssm_cfg(cfg)
    convs, ssms, kcs, vcs = [], [], [], []

    def run_stack(stacked, h, n):
        for i in range(n):
            bp = cm.layer(stacked, i)
            hn = ly.norm_apply(bp["norm"], h, cfg.norm_eps)
            out, st = ssm_mod.ssm_apply(bp["ssm"], hn, sc, ssd_impl=rc.ssd_impl,
                                        conv_impl=rc.conv_impl, return_state=True)
            h = h + out
            convs.append(st["conv"])
            ssms.append(st["ssm"])
        return h

    for g in range(n_groups):
        h = run_stack(cm.layer(params["mamba"], g), h, k)
        h, (kk, vv) = _shared_block(params["shared"], h, cfg, rc, positions)
        kcs.append(torch.nn.functional.pad(kk, (0, 0, 0, max_seq - L)))
        vcs.append(torch.nn.functional.pad(vv, (0, 0, 0, max_seq - L)))
    if rem:
        h = run_stack(params["mamba_tail"], h, rem)
    h = ly.norm_apply(params["norm_f"], h, cfg.norm_eps)
    logits = lo.logits_last(h[:, -1], head_weight(params, cfg))
    cache = {"conv": torch.stack(convs), "ssm": torch.stack(ssms),
             "k": torch.stack(kcs), "v": torch.stack(vcs)}
    return logits, cache


def decode_step(params, cfg: ArchConfig, rc: RunConfig, token, cache, pos):
    """token (B,) at index ``pos`` -> (logits (B, V) f32, cache). The cache
    is updated in place (the K/V caches are the bulk of it; the reference
    returns new arrays) and returned."""
    pos = int(pos)
    h = params["embed"][token[:, None]]
    n_groups, k, rem = _group_layout(cfg)
    sc = ssm_cfg(cfg)

    def run_stack(stacked, h, n, first):
        for i in range(n):
            bp = cm.layer(stacked, i)
            li = first + i
            hn = ly.norm_apply(bp["norm"], h, cfg.norm_eps)
            out, st = ssm_mod.ssm_decode(bp["ssm"], hn, sc,
                                         {"conv": cache["conv"][li], "ssm": cache["ssm"][li]})
            h = h + out
            cache["conv"][li] = st["conv"]
            cache["ssm"][li] = st["ssm"]
        return h

    sp = params["shared"]
    for g in range(n_groups):
        h = run_stack(cm.layer(params["mamba"], g), h, k, g * k)
        a_in = ly.norm_apply(sp["attn_norm"], h, cfg.norm_eps)
        a, _ = ly.attn_decode(sp["attn"], a_in, attn_cfg(cfg), cache["k"][g],
                              cache["v"][g], pos)
        h = h + a
        h = h + ly.mlp_apply(sp["mlp"], ly.norm_apply(sp["mlp_norm"], h, cfg.norm_eps))
    if rem:
        h = run_stack(params["mamba_tail"], h, rem, n_groups * k)
    h = ly.norm_apply(params["norm_f"], h, cfg.norm_eps)
    return lo.logits_last(h[:, -1], head_weight(params, cfg)), cache
