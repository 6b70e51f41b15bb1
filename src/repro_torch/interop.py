"""State carried between the JAX package and the port.

The reference's fields are ``jax.Array``s; taken to numpy (``np.asarray``),
they become the port's tensors with :func:`fields_from_numpy`, and the port's
tensors go back with :func:`fields_to_numpy`. Nothing here imports JAX.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from .core.device import resolve_device


def fields_from_numpy(arrays: Mapping[str, np.ndarray], *, device="cuda",
                      dtype: torch.dtype = torch.float32) -> dict[str, torch.Tensor]:
    """Each array as a new contiguous tensor of ``dtype`` on ``device``."""
    dev = resolve_device(device)
    return {n: torch.tensor(np.asarray(a), dtype=dtype, device=dev).contiguous()
            for n, a in arrays.items()}


def fields_to_numpy(fields: Mapping[str, torch.Tensor]) -> dict[str, np.ndarray]:
    """Each tensor as a numpy array on the host (a copy)."""
    return {n: t.detach().cpu().numpy().copy() for n, t in fields.items()}
