"""Mamba2's causal depthwise short convolution as a hand-written CUDA kernel.

Counterpart of the Pallas TPU kernel
``src/repro/kernels/conv1d.py::conv1d_causal``. The kernel is
``csrc/conv1d.cu`` (its header says what bounds it on the H100 and how its
design answers that); :func:`conv1d_causal` checks the arguments, builds
the kernel at first use and launches it on PyTorch's current stream. Its
plain version is :func:`plain`, used only for tensors that lie on the CPU.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import build, ref
from .args import all_on_cpu, check_cuda_tensors
from .stencil import stream_of

SOURCE = build.CSRC_DIR / "conv1d.cu"

# Launches of the CUDA kernel; :func:`conv1d_causal` adds one where it
# launches, and nowhere else.
launches = 0

# t positions each thread marches (the grid's z axis holds at most 65535
# segments)
SEGMENT = 64
_MAX_GRID_YZ = 65535

_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int64] * 6 + [ctypes.c_void_p]


@functools.cache
def library() -> build.Library:
    return build.Library("conv1d", build.read_source(SOURCE), _ARGTYPES)


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
    seg = max(SEGMENT, -(-L // _MAX_GRID_YZ))
    with torch.cuda.device(dev):
        library().launch(out.data_ptr(), x.data_ptr(), w.data_ptr(), b.data_ptr(),
                         B, L, C, K, seg, int(bool(silu)), stream_of(dev))
    launches += 1
    return out
