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

Both kernels cover the (L, C) slab of each batch row in tiles of 32 x
``vec`` channels by ``tile`` positions; :func:`layout` picks ``vec`` and
``tile`` from the shapes and the tensors' alignment, and the sources take
them as arguments and refuse any other.

x, w, b and the output (in the backward dout, dx, dw and db) are float32 or
bfloat16, one dtype a call, as the reference's kernel takes the parameter
dtype; each dtype runs its own instance of the sources (``library(bf16)``),
which converts to f32 on load, computes in f32 and rounds once on store.
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
# fold of dw and dbias), and nowhere else. ``last_layout`` is the (vec,
# tile) of the last launch of either (:func:`layout`).
launches = 0
launches_bwd = 0
last_layout = None

# A block's threads: 32 along C, each owning ``vec`` adjacent channels, by 4
# along t, each owning a run of tile / 4 positions (the sources' kLanes,
# kRows).
LANES, ROWS = 32, 4
# Positions a block covers, largest first: the largest that still gives
# MIN_BLOCKS blocks (16 on each of the H100's 132 SMs), else the smallest.
# The sources take these and no other. Timed on the card at 16, 32 and 64
# (PERF.md §6): 32 was the fastest at Zamba2's 4224 channels, forward and
# backward, 16 at mamba2-130m's 1792.
TILES = (32, 16)
MAX_TILE = 32
MIN_BLOCKS = 2112
_MAX_GRID_YZ = 65535

# The kernels keep their K inputs (the backward also its K gradients) in
# registers, one instance per K up to MAX_K (the sources' kMaxK); the
# forward takes a larger K in its generic kernel, the backward refuses it.
MAX_K = 8

_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int64] * 7 + [ctypes.c_void_p]
_BWD_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int64] * 7 + [ctypes.c_void_p]


@functools.cache
def library(bf16: bool = False) -> build.Library:
    return build.Library(*build.instance("conv1d", SOURCE, bf16), _ARGTYPES)


@functools.cache
def bwd_library(bf16: bool = False) -> build.Library:
    return build.Library(*build.instance("conv1d_bwd", BWD_SOURCE, bf16), _BWD_ARGTYPES)


def layout(B: int, L: int, C: int, K: int, *tensors) -> tuple[int, int]:
    """``(vec, tile)`` of a launch: ``vec`` channels a thread, 4 (one copy
    and one store of 4 channels: 16 bytes at f32, 8 at bf16) where K is at
    most MAX_K, C a multiple of 4 and each of ``tensors`` (those read and
    written along C) 16-byte aligned, else 1; ``tile`` positions a block,
    the largest of TILES that gives at least MIN_BLOCKS blocks, else the
    smallest. Neither depends on the dtype, so a bf16 call sums dw and
    dbias in the order of the f32 call on the same shapes."""
    vec = 4 if K <= MAX_K and C % 4 == 0 else 1
    for t in tensors:
        if t.data_ptr() % 16:
            vec = 1
    per_tile = -(-C // (LANES * vec)) * B
    for tile in TILES:
        if per_tile * -(-L // tile) >= MIN_BLOCKS:
            return vec, tile
    return vec, TILES[-1]


def layout_name(B: int, L: int, C: int, vec: int, tile: int) -> str:
    """``v<vec>/t<tile>/<grid>``: the grid is (position tiles, channel
    tiles, B) blocks."""
    return f"v{vec}/t{tile}/{-(-L // tile)}x{-(-C // (LANES * vec))}x{B}"


def smem_floats(K: int, vec: int, tile: int, size: int = 4) -> int:
    """Shared memory of a forward block in floats (the source's launch) for
    inputs of ``size`` bytes: tile + K - 1 rows of 32 x vec channels; none
    in the generic kernel."""
    return (tile + K - 1) * LANES * vec * size // 4 if K <= MAX_K else 0


def bwd_smem_floats(K: int, vec: int, tile: int, size: int = 4) -> int:
    """Shared memory of a backward block in floats (the source's
    ``bwd_smem_floats``) for inputs of ``size`` bytes: x's tile + 2(K-1)
    rows and g's tile + K - 1 of 32 x vec channels (and gp's tile + K - 1
    f32 rows where the inputs are narrower), or the partials' 4 x (K + 1)
    f32 rows where more."""
    staged = (2 * tile + 3 * (K - 1)) * size + (0 if size == 4 else (tile + K - 1) * 4)
    return max(staged, ROWS * (K + 1) * 4) * LANES * vec // 4


def plain(x, w, b=None, silu: bool = False):
    """The plain PyTorch version: the reference oracle (then SiLU) in f32,
    rounded once to x's dtype, as the reference's kernel and this one
    compute."""
    xf, wf = x.float(), w.float()
    out = ref.conv1d_causal(xf, wf, None if b is None else b.float())
    return (out * torch.sigmoid(out) if silu else out).to(x.dtype)


def conv1d_causal(x, w, b=None, silu: bool = False):
    """x (B, L, C), w (K, C), b (C,) or None -> (B, L, C):
    ``out[t] = sum_d w[d] x[t-d]`` (zero where ``t - d < 0``) plus the
    bias, then SiLU if asked, in x's dtype (float32 or bfloat16, which w
    and b share). CUDA tensors run the kernel; CPU tensors run the plain
    version."""
    global launches, last_layout
    if all_on_cpu(x, w, b):
        return plain(x, w, b, silu)
    if x.dim() != 3 or w.dim() != 2:
        raise ValueError(f"conv1d: x must be (B, L, C) and w (K, C), got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    B, L, C = x.shape
    K = w.shape[0]
    if b is None:
        b = torch.zeros((C,), dtype=x.dtype, device=x.device)
    dev, dtype = check_cuda_tensors({"x": (x, (B, L, C)), "w": (w, (K, C)),
                                     "b": (b, (C,))}, "conv1d")
    if K < 1 or B > _MAX_GRID_YZ:
        raise ValueError(f"conv1d: needs K >= 1 and B <= {_MAX_GRID_YZ}, got K={K}, B={B}")
    out, args = fwd_arguments(x, w, b, silu)
    with torch.cuda.device(dev):
        library(dtype == torch.bfloat16).launch(*args, stream_of(dev))
    launches += 1
    last_layout = args[8:10]
    return out


def fwd_arguments(x, w, b, silu: bool):
    """The forward kernel's output and its entry point's arguments but the
    stream, for tensors on one device (the card, or the CPU for
    ``rehearse``)."""
    B, L, C = x.shape
    K = w.shape[0]
    out = torch.empty_like(x)
    vec, tile = layout(B, L, C, K, x, out)
    return out, (out.data_ptr(), x.data_ptr(), w.data_ptr(), b.data_ptr(), B, L, C, K, vec,
                 tile, int(bool(silu)))


def bwd_arguments(dout, x, w, b, silu: bool):
    """The backward kernel's outputs (dx, dw, db), its entry point's
    arguments but the stream, and its scratch (a partial row of dw and
    dbias for each block: B x position tiles rows of (K + 1, C)), for
    tensors on one device (the card, or the CPU for ``rehearse``)."""
    B, L, C = x.shape
    K = w.shape[0]
    dx, dw, db = torch.empty_like(x), torch.empty_like(w), torch.empty_like(b)
    vec, tile = layout(B, L, C, K, dout, x, dx)
    part = torch.empty((B * -(-L // tile), K + 1, C), dtype=torch.float32, device=x.device)
    args = (dx.data_ptr(), dw.data_ptr(), db.data_ptr(), part.data_ptr(), dout.data_ptr(),
            x.data_ptr(), w.data_ptr(), b.data_ptr(), B, L, C, K, vec, tile, int(bool(silu)))
    return (dx, dw, db), args, part


def conv1d_causal_bwd(dout, x, w, b=None, silu: bool = False):
    """The gradients (dx, dw, db) of ``conv1d_causal(x, w, b, silu)`` given
    ``dout``, each in its input's dtype; db is None when b is. CUDA tensors
    run ``csrc/conv1d_bwd.cu``;
    CPU tensors run the plain version (``ref.conv1d_bwd``)."""
    global launches_bwd, last_layout
    if all_on_cpu(dout, x, w, b):
        return ref.conv1d_bwd(dout, x, w, b, silu)
    B, L, C = x.shape
    K = w.shape[0]
    if not 1 <= K <= MAX_K or B > _MAX_GRID_YZ:
        raise ValueError(f"conv1d_bwd: needs 1 <= K <= {MAX_K} and B <= {_MAX_GRID_YZ}, "
                         f"got K={K}, B={B}")
    bias = b if b is not None else torch.zeros((C,), dtype=x.dtype, device=x.device)
    dev, dtype = check_cuda_tensors({"dout": (dout, (B, L, C)), "x": (x, (B, L, C)),
                                     "w": (w, (K, C)), "b": (bias, (C,))}, "conv1d_bwd")
    (dx, dw, db), args, _part = bwd_arguments(dout, x, w, bias, silu)
    with torch.cuda.device(dev):
        bwd_library(dtype == torch.bfloat16).launch(*args, stream_of(dev))
    launches_bwd += 1
    last_layout = args[12:14]
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
