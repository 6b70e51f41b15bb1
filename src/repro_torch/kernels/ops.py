"""Public kernel entry points with an explicit implementation switch:
``impl="cuda"`` runs the hand-written kernel (its plain version for CPU
tensors), ``impl="ref"`` the plain PyTorch version. Decode's attention and
SSD step are plain PyTorch, as the reference computes them outside any
Pallas kernel.

Under ``impl="cuda"``, a call on CUDA tensors that needs a gradient runs
the kernel inside its ``torch.autograd.Function`` (``AttentionFn``,
``SSDFn``, ``Conv1dFn``), whose backward is a hand-written kernel too; on
CPU tensors the plain forward is differentiated directly."""
from __future__ import annotations

from typing import Optional

import torch

from . import attention as _attn_kernel
from . import conv1d as _conv_kernel
from . import diffusion3d as _diff_kernel
from . import ref as _ref
from . import ssd as _ssd_kernel
from .args import all_on_cpu
from .ref import NEG_INF


def _check_impl(impl: str) -> None:
    if impl not in ("cuda", "ref"):
        raise ValueError(f"impl must be 'cuda' or 'ref', got {impl!r}")


def _kernel_grad(*tensors) -> bool:
    """Whether a ``cuda`` call differentiates through the kernels' autograd
    Functions: grad mode on, some input needing a gradient, and the
    tensors on the card."""
    return (torch.is_grad_enabled() and not all_on_cpu(*tensors)
            and any(t is not None and t.requires_grad for t in tensors))


# =====================================================================
# 3-D diffusion step (paper Fig. 1)
# =====================================================================
def diffusion3d_step(T2, T, Ci, lam, dt, inv_dx, inv_dy, inv_dz, impl: str = "cuda"):
    """One step into a new tensor under either implementation (the kernel's
    in-place form is ``diffusion3d.diffusion3d_step(alias=True)``)."""
    _check_impl(impl)
    if impl == "cuda":
        return _diff_kernel.diffusion3d_step(T2, T, Ci, lam, dt, inv_dx, inv_dy, inv_dz,
                                             alias=False)
    return _ref.diffusion3d_step(T2, T, Ci, lam, dt, inv_dx, inv_dy, inv_dz)


# =====================================================================
# attention
# =====================================================================
def attention(q, k, v, causal: bool = True, window: Optional[int] = None,
              scale: Optional[float] = None, impl: str = "cuda"):
    """Self-attention with GQA; q (B, Hq, L, D), k/v (B, Hkv, L, D)."""
    _check_impl(impl)
    if impl == "cuda":
        if _kernel_grad(q, k, v):
            return _attn_kernel.AttentionFn.apply(q, k, v, causal, window, scale)
        return _attn_kernel.flash_attention(q, k, v, causal=causal, window=window,
                                            scale=scale)
    return _ref.attention(q, k, v, causal=causal, scale=scale, window=window)


def decode_attention(q, k_cache, v_cache, pos=None, window: Optional[int] = None,
                     scale: Optional[float] = None):
    """One-token decode: q (B, Hq, D) against the cache (B, Hkv, S, D) ->
    (B, Hq, D). ``pos``: the current token's index; keys after it (and,
    with ``window``, before its window) are masked. ``None`` attends to the
    whole cache."""
    B, Hq, D = q.shape
    Hkv, S = k_cache.shape[1], k_cache.shape[2]
    R = Hq // Hkv
    scale = (D ** -0.5) if scale is None else scale
    qg = q.reshape(B, Hkv, R, D).float() * scale
    s = torch.einsum("bgrd,bgkd->bgrk", qg, k_cache.float())
    kpos = torch.arange(S, device=q.device)
    mask = torch.ones((S,), dtype=torch.bool, device=q.device)
    if pos is not None:
        mask &= kpos <= pos
        if window is not None:
            mask &= kpos > pos - window
    elif window is not None:
        mask &= kpos > (S - 1) - window
    s = torch.where(mask[None, None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bgrk,bgkd->bgrd", p, v_cache.float())
    return out.reshape(B, Hq, D).to(q.dtype)


# =====================================================================
# Mamba2 SSD
# =====================================================================
def ssd(x, dt, A, Bm, Cm, D=None, h0=None, chunk: int = 64, impl: str = "cuda"):
    """SSD scan; Bm/Cm per state group (B, L, G, N). Returns
    (y (B, L, H, P), h_final (B, H, P, N) f32). ``impl="ref"`` is the chunked
    plain version (the twin of the reference's ``impl="chunked"``); the
    sequential oracle is ``ref.ssd_scan``."""
    _check_impl(impl)
    if impl == "cuda":
        if _kernel_grad(x, dt, A, Bm, Cm, D, h0):
            return _ssd_kernel.SSDFn.apply(x, dt, A, Bm, Cm, D, h0, chunk)
        return _ssd_kernel.ssd_chunk_scan(x, dt, A, Bm, Cm, D=D, h0=h0, chunk=chunk)
    return _ref.ssd(x, dt, A, Bm, Cm, D=D, h0=h0, chunk=chunk)


def ssd_decode_step(h, x_t, dt_t, A, B_t, C_t, D=None):
    """Single-token SSD recurrence. h (B, H, P, N) f32; x_t (B, H, P);
    dt_t (B, H); B_t/C_t (B, H, N). Returns (y_t, h_new)."""
    h, y = _ref.ssd_step(h, x_t.float(), dt_t.float(), A, B_t.float(), C_t.float())
    if D is not None:
        y = y + x_t.float() * D[None, :, None].float()
    return y.to(x_t.dtype), h


# =====================================================================
# causal depthwise conv1d
# =====================================================================
def conv1d_causal(x, w, b=None, silu: bool = False, impl: str = "cuda"):
    _check_impl(impl)
    if impl == "cuda":
        if _kernel_grad(x, w, b):
            return _conv_kernel.Conv1dFn.apply(x, w, b, silu)
        return _conv_kernel.conv1d_causal(x, w, b, silu=silu)
    return _conv_kernel.plain(x, w, b, silu=silu)
