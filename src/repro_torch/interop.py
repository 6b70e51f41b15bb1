"""State carried between the JAX package and the port.

The reference's fields are ``jax.Array``s; taken to numpy (``np.asarray``),
they become the port's tensors with :func:`fields_from_numpy`, and the port's
tensors go back with :func:`fields_to_numpy`. An LM parameter tree or
serving cache taken to numpy (``jax.tree.map(np.asarray, tree)``) becomes
the port's tree key for key with :func:`params_from_numpy` or
:func:`cache_from_numpy`, since both packages keep one layout; an AdamW
state (``m``, ``v``, ``count`` and, for low-precision parameters,
``master``) crosses with :func:`opt_state_from_numpy` and
:func:`opt_state_to_numpy`, so that a reference run's (params, opt_state)
continues in the port. Nothing here imports JAX.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from .core.device import resolve_device


def _host_array(a) -> np.ndarray:
    """``a`` as a numpy array torch can read: a bf16 array (``ml_dtypes``,
    the reference's storage) widened to f32, which is exact."""
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def fields_from_numpy(arrays: Mapping[str, np.ndarray], *, device="cuda",
                      dtype: torch.dtype = torch.float32) -> dict[str, torch.Tensor]:
    """Each array as a new contiguous tensor of ``dtype`` on ``device``: an
    f32 array given for bf16 or f16 fields is rounded once (to nearest
    even), a bf16 or f16 one is taken as it is."""
    dev = resolve_device(device)
    return {n: torch.tensor(_host_array(a), dtype=dtype, device=dev).contiguous()
            for n, a in arrays.items()}


def fields_to_numpy(fields: Mapping[str, torch.Tensor]) -> dict[str, np.ndarray]:
    """Each tensor as a numpy array on the host (a copy). bf16 fields come
    back as f32 arrays (exact: numpy has no bf16), f16 as f16."""
    return {n: (t.detach().float() if t.dtype == torch.bfloat16 else t.detach())
            .cpu().numpy().copy() for n, t in fields.items()}


def _leaf_from_numpy(a, dev) -> torch.Tensor:
    """A numpy array as a new tensor of the same dtype on ``dev``; a bf16
    array (``ml_dtypes``, which torch cannot read) crosses as its 16-bit
    words, bit for bit."""
    a = np.array(a, copy=True)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16).to(dev).contiguous()
    return torch.from_numpy(a).to(dev).contiguous()


def _tree_from_numpy(tree, dev):
    if isinstance(tree, Mapping):
        return {k: _tree_from_numpy(v, dev) for k, v in tree.items()}
    return _leaf_from_numpy(tree, dev)


def params_from_numpy(tree: Mapping, *, device="cuda") -> dict:
    """A nested dict of numpy arrays (the reference's parameter tree) as the
    port's tree: the same keys, each leaf a new tensor of the same dtype on
    ``device`` (bf16 leaves bit for bit)."""
    return _tree_from_numpy(tree, resolve_device(device))


def cache_from_numpy(cache: Mapping, *, device="cuda") -> dict:
    """The reference's serving cache as the port's, key for key: ``k``/``v``
    (attention families), ``mk``/``mv`` beside them (the enc-dec's
    cross-attention memory), ``conv``/``ssm`` (the SSM family; all four of
    ``conv``, ``ssm``, ``k``, ``v`` for the hybrid)."""
    return _tree_from_numpy(cache, resolve_device(device))


def cache_to_numpy(cache: Mapping) -> dict:
    """The port's serving cache as numpy arrays on the host (copies); bf16
    leaves come back as f32 (exact), as :func:`opt_state_to_numpy` gives
    them."""
    return opt_state_to_numpy(cache)


def opt_state_from_numpy(state: Mapping, *, device="cuda") -> dict:
    """The reference's AdamW state taken to numpy (``jax.tree.map(np.asarray,
    opt_state)``) as the port's ``optim.adamw`` state: the same keys, ``m``,
    ``v`` (and ``master``) f32 trees like the parameters', ``count`` an int32
    scalar tensor."""
    return _tree_from_numpy(state, resolve_device(device))


def opt_state_to_numpy(state: Mapping) -> dict:
    """The port's AdamW state (or any tree of tensors) as numpy arrays on the
    host (copies), key for key: what ``jax.tree.map(jnp.asarray, ...)``
    takes back into the reference. bf16 leaves come back as f32 (exact)."""
    return {n: (opt_state_to_numpy(t) if isinstance(t, Mapping) else
                (t.detach().float() if t.dtype == torch.bfloat16 else t.detach())
                .cpu().numpy().copy()) for n, t in state.items()}
