"""Mamba2 (SSD) layer, prefill and decode: the twin of
``src/repro/models/ssm.py``.

Prefill runs the causal short convolution through ``ops.conv1d_causal``
and the SSD scan through ``ops.ssd`` (the CUDA kernels, or their plain
versions with ``impl="ref"``). Decode keeps (conv window, ssm state) as the
cache, O(1) per token, and runs plain PyTorch, as the reference does.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from . import common as cm
from ..kernels import ops


@dataclasses.dataclass(frozen=True)
class SSMCfg:
    d_model: int
    d_state: int = 128       # N
    d_conv: int = 4          # K
    expand: int = 2
    head_dim: int = 64       # P
    n_groups: int = 1        # G
    chunk: int = 64
    dt_min: float = 0.001
    dt_max: float = 0.1

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def n_heads(self) -> int:
        return self.d_inner // self.head_dim

    @property
    def d_conv_in(self) -> int:
        return self.d_inner + 2 * self.n_groups * self.d_state


def ssm_init(gen: torch.Generator, cfg: SSMCfg, dtype: torch.dtype):
    D, Din, H = cfg.d_model, cfg.d_inner, cfg.n_heads
    GN = cfg.n_groups * cfg.d_state
    d_proj = 2 * Din + 2 * GN + H  # z, x, B, C, dt
    dev = gen.device
    in_proj = cm.normal(gen, (D, d_proj), D ** -0.5, dtype)
    conv_w = cm.normal(gen, (cfg.d_conv, cfg.d_conv_in), cfg.d_conv ** -0.5, dtype)
    out_proj = cm.normal(gen, (Din, D), Din ** -0.5, dtype)
    # dt bias: softplus^{-1} of a log-uniform dt in [dt_min, dt_max]
    u = cm.uniform(gen, (H,))
    lo, hi = math.log(cfg.dt_min), math.log(cfg.dt_max)
    dt0 = torch.exp(u * (hi - lo) + lo)
    dt_bias = dt0 + torch.log(-torch.expm1(-dt0))
    A0 = cm.uniform(gen, (H,), 1.0, 16.0)
    return {
        "in_proj": in_proj,
        "conv_w": conv_w,
        "conv_b": torch.zeros((cfg.d_conv_in,), dtype=dtype, device=dev),
        "dt_bias": dt_bias.float(),
        "A_log": torch.log(A0),
        "D": torch.ones((H,), dtype=torch.float32, device=dev),
        "norm": torch.ones((Din,), dtype=dtype, device=dev),
        "out_proj": out_proj,
    }


def _split_proj(zxbcdt, cfg: SSMCfg):
    Din = cfg.d_inner
    z = zxbcdt[..., :Din]
    xBC = zxbcdt[..., Din:Din + cfg.d_conv_in]
    dt = zxbcdt[..., Din + cfg.d_conv_in:]
    return z, xBC, dt


def _split_xbc(xBC, cfg: SSMCfg):
    Din, GN = cfg.d_inner, cfg.n_groups * cfg.d_state
    return xBC[..., :Din], xBC[..., Din:Din + GN], xBC[..., Din + GN:]


def _gate_norm_out(p, y, z):
    y = cm.rms_norm(y * cm.silu(z.float()).to(z.dtype), p["norm"])
    return y @ p["out_proj"]


def ssm_apply(p, h, cfg: SSMCfg, ssd_impl: str = "cuda", conv_impl: str = "cuda",
              return_state: bool = False):
    """h (B, L, D) -> (out, state or None). Full sequence (prefill). The
    state is {"conv": (B, K-1, Cin), the last K-1 conv inputs before the
    convolution, left-padded with zeros when L < K-1; "ssm": (B, H, P, N)}."""
    Bb, L, _ = h.shape
    H, P, G, N = cfg.n_heads, cfg.head_dim, cfg.n_groups, cfg.d_state
    zxbcdt = h @ p["in_proj"]
    z, xBC, dt_raw = _split_proj(zxbcdt, cfg)
    xBC = ops.conv1d_causal(xBC.contiguous(), p["conv_w"], p["conv_b"], silu=True,
                            impl=conv_impl)
    x, Bm, Cm = _split_xbc(xBC, cfg)
    dt = cm.softplus(dt_raw.float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    y, state = ops.ssd(
        x.reshape(Bb, L, H, P).contiguous(), dt.contiguous(), A,
        Bm.reshape(Bb, L, G, N).contiguous(), Cm.reshape(Bb, L, G, N).contiguous(),
        D=p["D"], chunk=cfg.chunk, impl=ssd_impl)
    out = _gate_norm_out(p, y.reshape(Bb, L, cfg.d_inner), z)
    if not return_state:
        return out, None
    # conv window: the last K-1 conv inputs, re-projected as the reference does
    K1 = cfg.d_conv - 1
    pad = max(K1 - L, 0)
    xBC_tail = _split_proj(h[:, L - (K1 - pad):] @ p["in_proj"], cfg)[1]
    if pad:
        xBC_tail = torch.nn.functional.pad(xBC_tail, (0, 0, pad, 0))
    return out, {"conv": xBC_tail, "ssm": state}


def ssm_decode(p, h, cfg: SSMCfg, cache):
    """One token. h (B, 1, D); cache {"conv": (B, K-1, Cin), "ssm": (B, H,
    P, N)}. Returns (out (B, 1, D), new cache) with new tensors."""
    Bb = h.shape[0]
    H, P, G, N = cfg.n_heads, cfg.head_dim, cfg.n_groups, cfg.d_state
    zxbcdt = h[:, 0] @ p["in_proj"]
    z, xBC_t, dt_raw = _split_proj(zxbcdt, cfg)
    # conv over the rolling window [conv_state, current]; w[d] multiplies
    # x[t-d], so the window (oldest first) meets the taps reversed
    win = torch.cat([cache["conv"], xBC_t[:, None]], dim=1)          # (B, K, Cin)
    w = p["conv_w"].float()
    conv = torch.sum(win.float() * w.flip(0)[None], dim=1) + p["conv_b"].float()
    conv = cm.silu(conv).to(h.dtype)
    x, Bm, Cm = _split_xbc(conv, cfg)
    dt = cm.softplus(dt_raw.float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    rep = H // G
    Bh = torch.repeat_interleave(Bm.reshape(Bb, G, N), rep, dim=1)
    Ch = torch.repeat_interleave(Cm.reshape(Bb, G, N), rep, dim=1)
    y, ssm_new = ops.ssd_decode_step(cache["ssm"], x.reshape(Bb, H, P), dt, A, Bh, Ch,
                                     D=p["D"])
    out = _gate_norm_out(p, y.reshape(Bb, cfg.d_inner), z)[:, None]
    return out, {"conv": win[:, 1:], "ssm": ssm_new}
