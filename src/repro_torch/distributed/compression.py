"""int8 block quantization, and the error-feedback int8 all-reduce.

Payloads are split into blocks of :data:`BLOCK` elements; each block is
scaled by its own ``max|block| / 127`` and rounded to int8. The halo
exchange's ``compress="int8"`` wire format ships the codes and the scales
(``quantize_int8``/``dequantize_int8``); ``compressed_psum`` sums the codes
of every rank in int32 against one shared per-block scale, carrying each
rank's quantization residual into its next call (error feedback,
Karimireddy et al. 2019).

The round trip's error is bounded by what this module's own arithmetic
does (:func:`int8_error_bound`): the rounding of the code (half a scale)
plus the f32 roundings of ``x / scale`` and ``q * scale``. The code's
rounding alone, ``scale / 2``, is not a bound: those f32 roundings can
push an element past it.

Pure functions on tensors of any device; the error state lives with the
caller.
"""
from __future__ import annotations

from typing import Optional

import torch

__all__ = ["BLOCK", "quantize_int8", "dequantize_int8", "int8_error_bound",
           "compressed_psum", "compression_ratio"]

BLOCK = 2048
_U32 = 2.0 ** -24      # f32 unit roundoff
_TINY = 2.0 ** -142    # covers the roundings of a subnormal scale (127 * 2^-150 < 2^-142)


def _blockify(g: torch.Tensor) -> tuple[torch.Tensor, tuple]:
    flat = g.reshape(-1)
    pad = (-flat.numel()) % BLOCK
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    return flat.reshape(-1, BLOCK), (tuple(g.shape), pad)


def _unblockify(b: torch.Tensor, meta) -> torch.Tensor:
    shape, pad = meta
    flat = b.reshape(-1)
    if pad:
        flat = flat[:-pad]
    return flat.reshape(shape)


def _codes(blocks: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)


def quantize_int8(g: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, tuple]:
    """Per-block symmetric int8 quantization of ``g`` (computed in f32).
    Returns ``(q, scales, meta)``: codes of shape ``(n_blocks, BLOCK)``,
    f32 scales of shape ``(n_blocks, 1)`` (1.0 for an all-zero block) and
    what :func:`dequantize_int8` needs to restore the shape."""
    blocks, meta = _blockify(g.to(torch.float32))
    scale = torch.amax(blocks.abs(), dim=1, keepdim=True) / 127.0
    scale = torch.where(scale > 0, scale, torch.ones_like(scale))
    return _codes(blocks, scale), scale, meta


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor, meta) -> torch.Tensor:
    """The f32 values ``q * scale`` in the shape ``meta`` names."""
    return _unblockify(q.to(torch.float32) * scale, meta)


def int8_error_bound(x: torch.Tensor, scale: torch.Tensor, meta) -> torch.Tensor:
    """Per element of ``x`` (as f64), the bound on ``|x - dequantize_int8(
    quantize_int8(x))|`` that this module's arithmetic gives, for finite
    ``x`` of magnitude at most ``2^127`` (nearer to f32's largest value,
    ``127 * scale`` can round past it: the code's product overflows):

        scale / 2  +  2^-24 * (|x| + 127 * scale)  +  2^-142

    ``scale / 2`` is the code's rounding; ``2^-24 |x|`` bounds the f32
    rounding of ``x / scale`` (times ``scale``), ``2^-24 * 127 * scale``
    that of ``q * scale``; ``2^-142`` covers a scale in f32's subnormal
    range, where the roundings are absolute (and the code may clip at 127)."""
    s = _unblockify(scale.to(torch.float64).expand(-1, BLOCK), meta)
    ax = x.to(torch.float64).abs()
    return 0.5 * s + _U32 * (ax + 127.0 * s) + _TINY


def compressed_psum(g: torch.Tensor, group=None, err: Optional[torch.Tensor] = None):
    """Error-feedback int8 all-reduce (sum) of ``g`` over ``group`` (a
    ``torch.distributed`` process group; None: the default group).

    Returns ``(g_reduced, new_err)``. The ranks first agree on one scale
    per block (an all-reduce ``MAX`` of ``n / BLOCK`` f32 values), every
    rank quantizes against it, and the full-size collective is the int32
    sum of the int8 codes: ``scale * sum(q)`` then equals ``sum(scale *
    q)`` exactly, which per-rank scales could not give. ``new_err`` is this
    rank's residual ``g - scale * q`` against what it put on the wire;
    feeding it to the next call keeps the accumulated sum unbiased. A CUDA
    tensor on a gloo group crosses through the host; without an
    initialized process group (a world of one rank) the sum is the rank's
    own quantized value."""
    import torch.distributed as dist

    g32 = g.to(torch.float32)
    if err is not None:
        g32 = g32 + err
    blocks, meta = _blockify(g32)
    scale = torch.amax(blocks.abs(), dim=1, keepdim=True) / 127.0
    staged = dist.is_initialized() and g.is_cuda and dist.get_backend(group) == "gloo"

    def all_reduce(t, op):
        if not dist.is_initialized():
            return t
        buf = t.cpu() if staged else t
        dist.all_reduce(buf, op=op, group=group)
        return buf.to(t.device) if staged else buf

    scale = all_reduce(scale.clone(), dist.ReduceOp.MAX)
    scale = torch.where(scale > 0, scale, torch.ones_like(scale))
    q = _codes(blocks, scale)
    new_err = _unblockify(blocks - q.to(torch.float32) * scale, meta)
    q_sum = all_reduce(q.to(torch.int32), dist.ReduceOp.SUM)
    return _unblockify(q_sum.to(torch.float32) * scale, meta), new_err


def compression_ratio() -> float:
    """Wire bytes per element against an f32 all-reduce (the int8 payload
    and one f32 scale per block)."""
    return (1.0 + 4.0 / BLOCK) / 4.0
