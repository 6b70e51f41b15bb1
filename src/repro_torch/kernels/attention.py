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

# Launches of the CUDA kernel; :func:`flash_attention` adds one where it
# launches, and nowhere else: to ``launches``, and to ``launches_by_mode``
# under "causal", "window" or "noncausal".
launches = 0
launches_by_mode: collections.Counter = collections.Counter()

# Head dimensions the kernel takes: whole 16-dim groups (one float4 of q and
# k per thread makes two 8-deep mma k-steps), at most 128.
HEAD_DIMS = (16, 32, 48, 64, 80, 96, 112, 128)
_MAX_GRID_Y = 65535

_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int64] * 8 + [ctypes.c_float]
             + [ctypes.c_void_p])


@functools.cache
def library() -> build.Library:
    return build.Library("attention", build.read_source(SOURCE), _ARGTYPES)


def flash_attention(q, k, v, causal: bool = True, window: Optional[int] = None,
                    scale: Optional[float] = None):
    """q (B, Hq, L, D), k/v (B, Hkv, L, D) -> (B, Hq, L, D); kv head =
    q head // (Hq / Hkv). CUDA tensors run the kernel; CPU tensors run the
    plain version."""
    global launches
    if all_on_cpu(q, k, v):
        return ref.attention(q, k, v, causal=causal, scale=scale, window=window)
    B, Hq, L, D = q.shape
    Hkv = k.shape[1]
    if Hkv < 1 or Hq % Hkv:
        raise ValueError(f"attention: Hkv={Hkv} must divide Hq={Hq}")
    if D not in HEAD_DIMS:
        raise ValueError(f"attention: head dim {D} is not one the kernel takes {HEAD_DIMS}")
    if B * Hq > _MAX_GRID_Y:
        raise ValueError(f"attention: B * Hq = {B * Hq} exceeds {_MAX_GRID_Y}")
    dev = check_cuda_tensors({"q": (q, (B, Hq, L, D)), "k": (k, (B, Hkv, L, D)),
                              "v": (v, (B, Hkv, L, D))}, "attention")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("attention: q, k and v must start on a 16-byte boundary")
    scale = (D ** -0.5) if scale is None else scale
    out = torch.empty_like(q)
    with torch.cuda.device(dev):
        library().launch(out.data_ptr(), q.data_ptr(), k.data_ptr(), v.data_ptr(),
                         B, Hq, Hkv, L, D, int(bool(causal)), int(window is not None),
                         0 if window is None else int(window), float(scale),
                         stream_of(dev))
    launches += 1
    launches_by_mode["window" if window is not None else
                     "causal" if causal else "noncausal"] += 1
    return out
