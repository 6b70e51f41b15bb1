"""Mamba2's causal depthwise short convolution as a hand-written CUDA kernel.

Counterpart of the Pallas TPU kernel
``src/repro/kernels/conv1d.py::conv1d_causal``. The kernel is
``csrc/conv1d.cu`` (its header says what bounds it on the H100 and how its
design answers that); :func:`conv1d_causal` checks the arguments, builds
the kernel at first use and launches it on PyTorch's current stream. Its
plain version is :func:`plain`, used only for tensors that lie on the CPU.

Training differentiates the kernel through :class:`Conv1dFn`, whose
backward is the hand-written kernel ``csrc/conv1d_bwd.cu``
(:func:`conv1d_causal_bwd`; plain version ``ref.conv1d_bwd``).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import build, ref
from .args import all_on_cpu, check_cuda_tensors
from .stencil import stream_of

SOURCE = build.CSRC_DIR / "conv1d.cu"
BWD_SOURCE = build.CSRC_DIR / "conv1d_bwd.cu"

# Launches of the CUDA kernels; :func:`conv1d_causal` adds one to
# ``launches`` where it launches, :func:`conv1d_causal_bwd` one to
# ``launches_bwd`` (a call makes two device launches: the kernel, then the
# fold of dw and dbias), and nowhere else.
launches = 0
launches_bwd = 0

# t positions each thread marches (the grid's z axis holds at most 65535
# segments)
SEGMENT = 64
_MAX_GRID_YZ = 65535

# the backward kernel keeps its K inputs and K gradients in registers
MAX_K_BWD = 8

_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int64] * 6 + [ctypes.c_void_p]
_BWD_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int64] * 6 + [ctypes.c_void_p]


@functools.cache
def library() -> build.Library:
    return build.Library("conv1d", build.read_source(SOURCE), _ARGTYPES)


@functools.cache
def bwd_library() -> build.Library:
    return build.Library("conv1d_bwd", build.read_source(BWD_SOURCE), _BWD_ARGTYPES)


def segment(L: int) -> int:
    """t positions a thread marches (the grid's z axis holds at most 65535
    segments)."""
    return max(SEGMENT, -(-L // _MAX_GRID_YZ))


def plain(x, w, b=None, silu: bool = False):
    """The plain PyTorch version: the reference oracle, then SiLU."""
    out = ref.conv1d_causal(x, w, b)
    return out * torch.sigmoid(out) if silu else out


def conv1d_causal(x, w, b=None, silu: bool = False):
    """x (B, L, C), w (K, C), b (C,) or None -> (B, L, C):
    ``out[t] = sum_d w[d] x[t-d]`` (zero where ``t - d < 0``) plus the
    bias, then SiLU if asked. CUDA tensors run the kernel; CPU tensors run
    the plain version."""
    global launches
    if all_on_cpu(x, w, b):
        return plain(x, w, b, silu)
    if x.dim() != 3 or w.dim() != 2:
        raise ValueError(f"conv1d: x must be (B, L, C) and w (K, C), got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    B, L, C = x.shape
    K = w.shape[0]
    if b is None:
        b = torch.zeros((C,), dtype=x.dtype, device=x.device)
    dev = check_cuda_tensors({"x": (x, (B, L, C)), "w": (w, (K, C)), "b": (b, (C,))},
                             "conv1d")
    if K < 1 or B > _MAX_GRID_YZ:
        raise ValueError(f"conv1d: needs K >= 1 and B <= {_MAX_GRID_YZ}, got K={K}, B={B}")
    out = torch.empty_like(x)
    seg = segment(L)
    with torch.cuda.device(dev):
        library().launch(out.data_ptr(), x.data_ptr(), w.data_ptr(), b.data_ptr(),
                         B, L, C, K, seg, int(bool(silu)), stream_of(dev))
    launches += 1
    return out


def bwd_arguments(dout, x, w, b, silu: bool):
    """The backward kernel's outputs (dx, dw, db) and its entry point's
    arguments but the stream, for tensors on one device (the card, or the
    CPU for ``rehearse``)."""
    B, L, C = x.shape
    K = w.shape[0]
    seg = segment(L)
    dx, dw, db = torch.empty_like(x), torch.empty_like(w), torch.empty_like(b)
    part = torch.empty((B * -(-L // seg), K + 1, C), dtype=torch.float32, device=x.device)
    args = (dx.data_ptr(), dw.data_ptr(), db.data_ptr(), part.data_ptr(), dout.data_ptr(),
            x.data_ptr(), w.data_ptr(), b.data_ptr(), B, L, C, K, seg, int(bool(silu)))
    return (dx, dw, db), args, part


def conv1d_causal_bwd(dout, x, w, b=None, silu: bool = False):
    """The gradients (dx, dw, db) of ``conv1d_causal(x, w, b, silu)`` given
    ``dout``; db is None when b is. CUDA tensors run ``csrc/conv1d_bwd.cu``;
    CPU tensors run the plain version (``ref.conv1d_bwd``)."""
    global launches_bwd
    if all_on_cpu(dout, x, w, b):
        return ref.conv1d_bwd(dout, x, w, b, silu)
    B, L, C = x.shape
    K = w.shape[0]
    if not 1 <= K <= MAX_K_BWD or B > _MAX_GRID_YZ:
        raise ValueError(f"conv1d_bwd: needs 1 <= K <= {MAX_K_BWD} and B <= {_MAX_GRID_YZ}, "
                         f"got K={K}, B={B}")
    bias = b if b is not None else torch.zeros((C,), dtype=x.dtype, device=x.device)
    dev = check_cuda_tensors({"dout": (dout, (B, L, C)), "x": (x, (B, L, C)),
                              "w": (w, (K, C)), "b": (bias, (C,))}, "conv1d_bwd")
    (dx, dw, db), args, _part = bwd_arguments(dout, x, w, bias, silu)
    with torch.cuda.device(dev):
        bwd_library().launch(*args, stream_of(dev))
    launches_bwd += 1
    return dx, dw, (db if b is not None else None)


class Conv1dFn(torch.autograd.Function):
    """:func:`conv1d_causal` with its backward on ``csrc/conv1d_bwd.cu``:
    what ``ops.conv1d_causal`` runs on CUDA tensors that need a gradient."""

    @staticmethod
    def forward(ctx, x, w, b, silu):
        ctx.silu = bool(silu)
        ctx.save_for_backward(x, w, b)
        return conv1d_causal(x, w, b, silu=silu)

    @staticmethod
    def backward(ctx, dout):
        x, w, b = ctx.saved_tensors
        dx, dw, db = conv1d_causal_bwd(dout.contiguous(), x, w, b, ctx.silu)
        return dx, dw, db, None
