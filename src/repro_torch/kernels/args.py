"""Argument checks shared by the LM kernels' wrappers (conv1d, ssd,
attention): every tensor on one CUDA device, float32, C-contiguous and of
the shape the kernel expects. Nothing is moved, cast or copied silently."""
from __future__ import annotations

from typing import Mapping, Sequence

import torch


def check_cuda_tensors(args: Mapping[str, tuple[torch.Tensor, Sequence[int]]],
                       kernel: str) -> torch.device:
    """``args``: name -> (tensor, expected shape). Returns the device."""
    devices = {t.device for t, _ in args.values()}
    if len(devices) != 1:
        raise ValueError(f"{kernel}: arguments lie on several devices "
                         f"{sorted(map(str, devices))}")
    (dev,) = devices
    if dev.type != "cuda":
        raise ValueError(f"{kernel}: the CUDA kernel takes CUDA tensors, got {dev}")
    for n, (t, shape) in args.items():
        if t.dtype != torch.float32:
            raise TypeError(
                f"{kernel}: {n!r} is {t.dtype}; the CUDA kernel takes float32 (bf16 "
                "inputs are ROADMAP queue 2, items 3-5)")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{kernel}: {n!r} has shape {tuple(t.shape)}, "
                             f"expected {tuple(shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{kernel}: {n!r} is not contiguous")
    return dev


def all_on_cpu(*tensors) -> bool:
    return all(t.device.type == "cpu" for t in tensors if t is not None)
