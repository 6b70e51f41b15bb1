"""Causal / sliding-window self-attention with GQA as a hand-written CUDA
kernel on the tensor cores (forward, 3xTF32: f32-accurate).

Counterpart of the Pallas TPU kernel
``src/repro/kernels/attention.py::flash_attention``. The kernel is
``csrc/attention.cu`` (its header says what bounds it on the H100 and how
its design answers that); :func:`flash_attention` checks the arguments,
builds the kernel at first use and launches it on PyTorch's current stream.
Its plain version is :func:`repro_torch.kernels.ref.attention`, used only
for tensors that lie on the CPU.

Self-attention only (Lq == Lk), as the TPU kernel. Decode against a cache
is ``ops.decode_attention``, plain PyTorch, as in the reference.

Training differentiates the kernel through :class:`AttentionFn`: the
forward also writes each row's log-sum-exp, and the backward is the
hand-written ``csrc/attention_bwd.cu`` (:func:`flash_attention_bwd`; plain
version ``ref.attention_bwd``).

q, k, v and the output (in the backward also dout, dq, dk and dv) are
float32 or bfloat16, one dtype a call, as the reference's kernel takes the
parameter dtype; the log-sum-exp is float32, and so is the output the
backward reads (the forward's ``out32``, its output before rounding: the
bf16 output would put an error of about 1e-3 of the largest gradient into
dq and dk through delta = dout·out). Each dtype runs its own instance of
the sources (``library(bf16)``), which converts to f32 on load, computes in
f32 and rounds once on store.
"""
from __future__ import annotations

import collections
import ctypes
import functools
from typing import Optional

import torch

from . import build, ref
from .args import all_on_cpu, check_cuda_tensors
from .stencil import stream_of

SOURCE = build.CSRC_DIR / "attention.cu"
BWD_SOURCE = build.CSRC_DIR / "attention_bwd.cu"

# Launches of the CUDA kernels; :func:`flash_attention` adds one where it
# launches, and nowhere else: to ``launches``, and to ``launches_by_mode``
# under "causal", "window" or "noncausal"; :func:`flash_attention_bwd` one to
# ``launches_bwd`` (a call makes three device launches: delta, dk and dv,
# dq).
launches = 0
launches_by_mode: collections.Counter = collections.Counter()
launches_bwd = 0

# Head dimensions the kernel takes: whole 16-dim groups (one float4 of q and
# k per thread makes two 8-deep mma k-steps), at most 128.
HEAD_DIMS = (16, 32, 48, 64, 80, 96, 112, 128)
_MAX_GRID_Y = 65535

_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int64] * 8 + [ctypes.c_float]
             + [ctypes.c_void_p])
_BWD_ARGTYPES = ([ctypes.c_void_p] * 10 + [ctypes.c_int64] * 8 + [ctypes.c_float]
                 + [ctypes.c_void_p])
# the backward's blocks own 64 rows (keys for dK/dV, query rows for dQ) and
# walk inner tiles of ``bwd_tile(D)`` rows: 64, 32 at D = 80, 16 at D >= 96
BWD_ROWS = 64


def bwd_tile(D: int) -> int:
    """Rows of the backward's inner tiles at head dim D (``csrc/attention_bwd.cu``'s
    ``Shape<D>::kBI``)."""
    return 64 if D <= 64 else 32 if D <= 80 else 16


@functools.cache
def library(bf16: bool = False) -> build.Library:
    return build.Library(*build.instance("attention", SOURCE, bf16), _ARGTYPES)


@functools.cache
def bwd_library(bf16: bool = False) -> build.Library:
    return build.Library(*build.instance("attention_bwd", BWD_SOURCE, bf16), _BWD_ARGTYPES)


def bwd_smem_floats(D: int) -> int:
    """Shared memory of a backward block in floats (``csrc/attention_bwd.cu``'s
    ``smem_floats``): the block's own two tiles of BWD_ROWS rows and two
    stages of two inner tiles (rows of D padded to a multiple of 32 words)
    with the rows' lse and delta."""
    ld, bi = -(-D // 32) * 32, bwd_tile(D)
    return 2 * BWD_ROWS * ld + 2 * (2 * bi * ld + 2 * bi)


def _check(q, k, v, what: str):
    """(B, Hq, Hkv, L, D), or ValueError for a shape the kernels refuse."""
    B, Hq, L, D = q.shape
    Hkv = k.shape[1]
    if Hkv < 1 or Hq % Hkv:
        raise ValueError(f"{what}: Hkv={Hkv} must divide Hq={Hq}")
    if D not in HEAD_DIMS:
        raise ValueError(f"{what}: head dim {D} is not one the kernel takes {HEAD_DIMS}")
    if B * Hq > _MAX_GRID_Y:
        raise ValueError(f"{what}: B * Hq = {B * Hq} exceeds {_MAX_GRID_Y}")
    return B, Hq, Hkv, L, D


def flash_attention(q, k, v, causal: bool = True, window: Optional[int] = None,
                    scale: Optional[float] = None, return_lse: bool = False,
                    return_out32: bool = False):
    """q (B, Hq, L, D), k/v (B, Hkv, L, D) -> (B, Hq, L, D) in q's dtype;
    kv head = q head // (Hq / Hkv). With ``return_lse``, also each row's
    log-sum-exp of its scaled scores (B, Hq, L) f32 (-inf for a row with no
    key); with ``return_out32``, then the output before rounding, f32 (the
    output itself for f32 inputs), which :func:`flash_attention_bwd` reads.
    CUDA tensors run the kernel; CPU tensors run the plain version."""
    global launches
    if all_on_cpu(q, k, v):
        out32 = ref.attention(q.float(), k.float(), v.float(), causal=causal, scale=scale,
                              window=window)
        extra = ((ref.attention_lse(q, k, causal=causal, scale=scale, window=window),)
                 if return_lse else ()) + ((out32,) if return_out32 else ())
        out = out32.to(q.dtype)
        return (out, *extra) if extra else out
    B, Hq, Hkv, L, D = _check(q, k, v, "attention")
    dev, dtype = check_cuda_tensors({"q": (q, (B, Hq, L, D)), "k": (k, (B, Hkv, L, D)),
                                     "v": (v, (B, Hkv, L, D))}, "attention")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("attention: q, k and v must start on a 16-byte boundary")
    scale = (D ** -0.5) if scale is None else scale
    out = torch.empty_like(q)
    lse = (torch.empty((B, Hq, L), dtype=torch.float32, device=q.device) if return_lse
           else None)
    bf16 = dtype == torch.bfloat16
    out32 = (torch.empty(q.shape, dtype=torch.float32, device=q.device)
             if return_out32 and bf16 else None)
    with torch.cuda.device(dev):
        library(bf16).launch(
            out.data_ptr(), None if lse is None else lse.data_ptr(),
            None if out32 is None else out32.data_ptr(), q.data_ptr(), k.data_ptr(),
            v.data_ptr(), B, Hq, Hkv, L, D, int(bool(causal)), int(window is not None),
            0 if window is None else int(window), float(scale), stream_of(dev))
    launches += 1
    launches_by_mode["window" if window is not None else
                     "causal" if causal else "noncausal"] += 1
    extra = ((lse,) if return_lse else ()) + \
        ((out if out32 is None else out32,) if return_out32 else ())
    return (out, *extra) if extra else out


def bwd_arguments(q, k, v, out, dout, lse, causal, window, scale):
    """The backward kernel's outputs (dq, dk, dv) and its entry point's
    arguments but the stream, for tensors on one device (the card, or the
    CPU for ``rehearse``)."""
    B, Hq, L, D = q.shape
    Hkv = k.shape[1]
    scale = (D ** -0.5) if scale is None else scale
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty((B, Hq, L), dtype=torch.float32, device=q.device)
    args = (dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), delta.data_ptr(), q.data_ptr(),
            k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(), lse.data_ptr(),
            B, Hq, Hkv, L, D, int(bool(causal)), int(window is not None),
            0 if window is None else int(window), float(scale))
    return (dq, dk, dv), args, delta


def flash_attention_bwd(q, k, v, out, dout, lse, causal: bool = True,
                        window: Optional[int] = None, scale: Optional[float] = None):
    """(dq, dk, dv) of :func:`flash_attention` given ``dout``, from the
    forward's output before rounding ``out`` (f32: the output itself at
    f32, ``return_out32``'s at bf16) and log-sum-exp ``lse``, each in its
    input's dtype. CUDA tensors run ``csrc/attention_bwd.cu``; CPU tensors
    run the plain version (``ref.attention_bwd``)."""
    global launches_bwd
    if all_on_cpu(q, k, v, dout):
        return ref.attention_bwd(q, k, v, dout, causal=causal, scale=scale, window=window)
    B, Hq, Hkv, L, D = _check(q, k, v, "attention_bwd")
    dev, dtype = check_cuda_tensors({"q": (q, (B, Hq, L, D)), "k": (k, (B, Hkv, L, D)),
                                     "v": (v, (B, Hkv, L, D)), "out": (out, (B, Hq, L, D)),
                                     "dout": (dout, (B, Hq, L, D)), "lse": (lse, (B, Hq, L))},
                                    "attention_bwd", ("out", "lse"))
    # the kernels copy 16 bytes at a time: a tensor off a 16-byte boundary is
    # copied to one on it
    q, k, v, dout = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (q, k, v, dout))
    (dq, dk, dv), args, _delta = bwd_arguments(q, k, v, out, dout, lse, causal, window, scale)
    with torch.cuda.device(dev):
        bwd_library(dtype == torch.bfloat16).launch(*args, stream_of(dev))
    launches_bwd += 1
    return dq, dk, dv


class AttentionFn(torch.autograd.Function):
    """:func:`flash_attention` with its backward on ``csrc/attention_bwd.cu``:
    what ``ops.attention`` runs on CUDA tensors that need a gradient."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale):
        out, lse, out32 = flash_attention(q, k, v, causal=causal, window=window, scale=scale,
                                          return_lse=True, return_out32=True)
        ctx.opts = (causal, window, scale)
        ctx.save_for_backward(q, k, v, out32, lse)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        causal, window, scale = ctx.opts
        dq, dk, dv = flash_attention_bwd(q, k, v, out, dout.contiguous(), lse, causal=causal,
                                         window=window, scale=scale)
        return dq, dk, dv, None, None, None
