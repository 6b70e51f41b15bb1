"""Argument checks shared by the LM kernels' wrappers (conv1d, ssd,
attention): every tensor on one CUDA device, of the dtype the kernel takes,
C-contiguous and of the shape the kernel expects. Nothing is moved, cast or
copied silently.

The dtype rule is the reference's (its Pallas kernels build their call at
the input's dtype and keep some inputs in f32): each kernel's *storage*
tensors (conv1d's x, w and b; SSD's x, Bm and Cm; attention's q, k and v,
and the forward's output and its gradient in the backward) are float32 or
bfloat16, all of one call the same; every other tensor (dt, A, D, h0,
dh_final, the states, h_final, lse) is float32. The outputs take their
inputs' dtype."""
from __future__ import annotations

from typing import Collection, Mapping, Sequence

import torch

# the dtypes a storage tensor of a CUDA kernel may have; each has a library
# of its own (``build.instance``)
STORAGE_DTYPES = (torch.float32, torch.bfloat16)


def storage_dtype(kernel: str, dtypes: Mapping[str, torch.dtype],
                  f32: Collection[str] = ()) -> torch.dtype:
    """The storage dtype of a call, from each argument's dtype by name;
    the names in ``f32`` must be float32, the others one dtype of
    STORAGE_DTYPES. Raises TypeError otherwise."""
    for n in f32:
        if dtypes[n] != torch.float32:
            raise TypeError(f"{kernel}: {n!r} is {dtypes[n]}; the CUDA kernel keeps it in "
                            "float32, as the reference's kernel does")
    storage = {n: d for n, d in dtypes.items() if n not in f32}
    for n, d in storage.items():
        if d == torch.float16:
            raise TypeError(
                f"{kernel}: {n!r} is float16; the reference's kernels take it, the CUDA "
                "kernel does not yet (ROADMAP queue 2, sites 3-5: float16 inputs)")
        if d not in STORAGE_DTYPES:
            raise TypeError(f"{kernel}: {n!r} is {d}; the CUDA kernel takes float32 or "
                            "bfloat16")
    if len(set(storage.values())) > 1:
        raise TypeError(f"{kernel}: the arguments {sorted(storage)} must share one dtype, got "
                        f"{ {n: str(d) for n, d in storage.items()} }")
    return next(iter(storage.values()), torch.float32)


def check_cuda_tensors(args: Mapping[str, tuple[torch.Tensor, Sequence[int]]], kernel: str,
                       f32: Collection[str] = ()) -> tuple[torch.device, torch.dtype]:
    """``args``: name -> (tensor, expected shape); ``f32``: the names kept
    in float32 (:func:`storage_dtype`). Returns (the device, the storage
    dtype)."""
    devices = {t.device for t, _ in args.values()}
    if len(devices) != 1:
        raise ValueError(f"{kernel}: arguments lie on several devices "
                         f"{sorted(map(str, devices))}")
    (dev,) = devices
    if dev.type != "cuda":
        raise ValueError(f"{kernel}: the CUDA kernel takes CUDA tensors, got {dev}")
    dtype = storage_dtype(kernel, {n: t.dtype for n, (t, _) in args.items()},
                          [n for n in f32 if n in args])
    for n, (t, shape) in args.items():
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{kernel}: {n!r} has shape {tuple(t.shape)}, "
                             f"expected {tuple(shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{kernel}: {n!r} is not contiguous")
    return dev, dtype


def all_on_cpu(*tensors) -> bool:
    return all(t.device.type == "cpu" for t in tensors if t is not None)
