"""Encoder-decoder transformer (the Seamless-M4T backbone), serving: the
twin of ``src/repro/models/encdec.py``.

The modality frontend is a stub: the encoder takes precomputed frame
embeddings (B, S_src, D). Encoder blocks are bidirectional self-attention
(the attention kernel with ``causal=False``) and an MLP; decoder blocks are
causal self-attention (the attention kernel in prefill), cross-attention to
the encoder memory, and an MLP. The cross-attention K/V are computed once
at prefill and cached (``mk``/``mv``). ``decode_train`` and ``loss_fn``
train it, each encoder and decoder block rematerialised under ``rc.remat``.
"""
from __future__ import annotations

import dataclasses

import torch

from . import common as cm
from . import layers as ly
from . import losses as lo
from ..kernels import ops, ref
from .config import ArchConfig, RunConfig
from .transformer import attn_cfg, head_weight, param_dtype


def _enc_attn_cfg(cfg: ArchConfig) -> ly.AttnCfg:
    return dataclasses.replace(attn_cfg(cfg), causal=False, window=None)


def enc_block_init(gen: torch.Generator, cfg: ArchConfig, dtype):
    dev = gen.device
    return {
        "attn_norm": ly.norm_init(cfg.d_model, dtype, dev),
        "attn": ly.attn_init(gen, _enc_attn_cfg(cfg), dtype),
        "mlp_norm": ly.norm_init(cfg.d_model, dtype, dev),
        "mlp": ly.mlp_init(gen, cfg.d_model, cfg.d_ff, dtype),
    }


def dec_block_init(gen: torch.Generator, cfg: ArchConfig, dtype):
    dev = gen.device
    return {
        "self_norm": ly.norm_init(cfg.d_model, dtype, dev),
        "self_attn": ly.attn_init(gen, attn_cfg(cfg), dtype),
        "cross_norm": ly.norm_init(cfg.d_model, dtype, dev),
        # cross-attention: q from the decoder, k/v from the encoder memory
        "cross_attn": ly.attn_init(gen, attn_cfg(cfg), dtype),
        "mlp_norm": ly.norm_init(cfg.d_model, dtype, dev),
        "mlp": ly.mlp_init(gen, cfg.d_model, cfg.d_ff, dtype),
    }


def model_init(gen: torch.Generator, cfg: ArchConfig, rc: RunConfig):
    dtype, dev = param_dtype(rc), gen.device
    tree = {
        "embed": cm.normal(gen, (cfg.vocab, cfg.d_model), 0.02, dtype),
        "enc_blocks": cm.stack_layers(cfg.n_enc_layers,
                                      lambda: enc_block_init(gen, cfg, dtype)),
        "dec_blocks": cm.stack_layers(cfg.n_dec_layers,
                                      lambda: dec_block_init(gen, cfg, dtype)),
        "enc_norm_f": ly.norm_init(cfg.d_model, dtype, dev),
        "norm_f": ly.norm_init(cfg.d_model, dtype, dev),
    }
    if not cfg.tie_embeddings:
        tree["lm_head"] = cm.normal(gen, (cfg.d_model, cfg.vocab), cfg.d_model ** -0.5,
                                    dtype)
    return tree


def _cross_attend(p, x, memory_kv, cfg: ArchConfig):
    """x (B, Lq, D) attends to the precomputed encoder K/V (B, Hkv, S, Dh).

    Plain PyTorch on every device: the reference sends cross-attention to no
    Pallas kernel (``ops.attention(impl="chunked")`` for Lq > 1,
    ``ops.decode_attention`` for Lq = 1), and the attention kernel takes
    self-attention only (Lq == Lk)."""
    B, Lq, _ = x.shape
    H, Dh = cfg.n_heads, cfg.head_dim
    q = (x @ p["wq"]).reshape(B, Lq, H, Dh).transpose(1, 2)
    mk, mv = memory_kv
    if Lq == 1:
        out = ops.decode_attention(q[:, :, 0], mk, mv).reshape(B, 1, H * Dh)
    else:
        out = ref.attention(q, mk, mv, causal=False).transpose(1, 2).reshape(B, Lq, H * Dh)
    return out @ p["wo"]


def encode(params, cfg: ArchConfig, rc: RunConfig, frames):
    """frames (B, S_src, D), the stub frontend's embeddings -> the encoder
    memory (B, S_src, D)."""
    h = frames.to(param_dtype(rc))
    B, S, _ = h.shape
    positions = torch.arange(S, device=h.device).expand(B, S)

    def body(bp, h):
        a_in = ly.norm_apply(bp["attn_norm"], h, cfg.norm_eps)
        a, _ = ly.attn_apply(bp["attn"], a_in, _enc_attn_cfg(cfg), positions,
                             attn_impl=rc.attn_impl)
        h = h + a
        return h + ly.mlp_apply(bp["mlp"], ly.norm_apply(bp["mlp_norm"], h, cfg.norm_eps))

    body = cm.remat(body, rc.remat, rc.remat_policy)
    for bp in cm.unstack(params["enc_blocks"], cfg.n_enc_layers):
        h = body(bp, h)
    return ly.norm_apply(params["enc_norm_f"], h, cfg.norm_eps)


def _memory_kv(bp, memory, cfg: ArchConfig):
    """The cross-attention K/V (B, Hkv, S, Dh) of one layer from the
    encoder memory."""
    B, S, _ = memory.shape
    Hkv, Dh = cfg.n_kv_heads, cfg.head_dim
    k = (memory @ bp["wk"]).reshape(B, S, Hkv, Dh).transpose(1, 2)
    v = (memory @ bp["wv"]).reshape(B, S, Hkv, Dh).transpose(1, 2)
    return k, v


def decode_train(params, cfg: ArchConfig, rc: RunConfig, memory, tokens):
    """The teacher-forced decoder over ``tokens`` (B, L) against the encoder
    memory -> the final-normed hidden (B, L, D)."""
    h = params["embed"][tokens]
    B, L, _ = h.shape
    positions = torch.arange(L, device=h.device).expand(B, L)

    def body(bp, h):
        a_in = ly.norm_apply(bp["self_norm"], h, cfg.norm_eps)
        a, _ = ly.attn_apply(bp["self_attn"], a_in, attn_cfg(cfg), positions,
                             attn_impl=rc.attn_impl)
        h = h + a
        c_in = ly.norm_apply(bp["cross_norm"], h, cfg.norm_eps)
        mkv = _memory_kv(bp["cross_attn"], memory, cfg)
        h = h + _cross_attend(bp["cross_attn"], c_in, mkv, cfg)
        return h + ly.mlp_apply(bp["mlp"], ly.norm_apply(bp["mlp_norm"], h, cfg.norm_eps))

    body = cm.remat(body, rc.remat, rc.remat_policy)
    for bp in cm.unstack(params["dec_blocks"], cfg.n_dec_layers):
        h = body(bp, h)
    return ly.norm_apply(params["norm_f"], h, cfg.norm_eps)


def loss_fn(params, cfg: ArchConfig, rc: RunConfig, tokens, labels, frames):
    """tokens/labels (B, L) (labels with ``losses.IGNORE`` padding); frames
    (B, S_src, D), the stub frontend's embeddings."""
    memory = encode(params, cfg, rc, frames)
    h = decode_train(params, cfg, rc, memory, tokens)
    return lo.chunked_softmax_xent(h, head_weight(params, cfg), labels,
                                   chunk=rc.loss_chunk, z_loss=rc.z_loss)


def init_cache(cfg: ArchConfig, rc: RunConfig, batch: int, max_seq: int, device,
               dtype=None, source_len=None):
    dtype = param_dtype(rc) if dtype is None else dtype
    Ln, Hkv, Dh = cfg.n_dec_layers, cfg.n_kv_heads, cfg.head_dim
    S = cfg.source_len if source_len is None else source_len

    def zeros(n):
        return torch.zeros((Ln, batch, Hkv, n, Dh), dtype=dtype, device=device)

    return {"k": zeros(max_seq), "v": zeros(max_seq), "mk": zeros(S), "mv": zeros(S)}


def prefill(params, cfg: ArchConfig, rc: RunConfig, tokens, max_seq: int, frames):
    """Encode the source, then a teacher-forced decoder pass over ``tokens``
    -> (last-position logits (B, V) f32, cache {k, v, mk, mv})."""
    memory = encode(params, cfg, rc, frames)
    h = params["embed"][tokens]
    B, L, _ = h.shape
    if L > max_seq:
        raise ValueError(f"prompt of {L} tokens exceeds max_seq={max_seq}")
    positions = torch.arange(L, device=h.device).expand(B, L)
    cache = init_cache(cfg, rc, B, max_seq, h.device, source_len=memory.shape[1])
    for i in range(cfg.n_dec_layers):
        bp = cm.layer(params["dec_blocks"], i)
        a_in = ly.norm_apply(bp["self_norm"], h, cfg.norm_eps)
        a, (k, v) = ly.attn_apply(bp["self_attn"], a_in, attn_cfg(cfg), positions,
                                  attn_impl=rc.attn_impl)
        h = h + a
        c_in = ly.norm_apply(bp["cross_norm"], h, cfg.norm_eps)
        mk, mv = _memory_kv(bp["cross_attn"], memory, cfg)
        h = h + _cross_attend(bp["cross_attn"], c_in, (mk, mv), cfg)
        h = h + ly.mlp_apply(bp["mlp"], ly.norm_apply(bp["mlp_norm"], h, cfg.norm_eps))
        cache["k"][i, :, :, :L] = k
        cache["v"][i, :, :, :L] = v
        cache["mk"][i] = mk
        cache["mv"][i] = mv
    h = ly.norm_apply(params["norm_f"], h, cfg.norm_eps)
    return lo.logits_last(h[:, -1], head_weight(params, cfg)), cache


def decode_step(params, cfg: ArchConfig, rc: RunConfig, token, cache, pos):
    """token (B,) at index ``pos`` -> (logits (B, V) f32, cache); the
    self-attention caches are updated in place, the memory's K/V kept."""
    pos = int(pos)
    h = params["embed"][token[:, None]]
    for i in range(cfg.n_dec_layers):
        bp = cm.layer(params["dec_blocks"], i)
        a_in = ly.norm_apply(bp["self_norm"], h, cfg.norm_eps)
        a, _ = ly.attn_decode(bp["self_attn"], a_in, attn_cfg(cfg), cache["k"][i],
                              cache["v"][i], pos)
        h = h + a
        c_in = ly.norm_apply(bp["cross_norm"], h, cfg.norm_eps)
        h = h + _cross_attend(bp["cross_attn"], c_in, (cache["mk"][i], cache["mv"][i]), cfg)
        h = h + ly.mlp_apply(bp["mlp"], ly.norm_apply(bp["mlp_norm"], h, cfg.norm_eps))
    h = ly.norm_apply(params["norm_f"], h, cfg.norm_eps)
    return lo.logits_last(h[:, -1], head_weight(params, cfg)), cache
