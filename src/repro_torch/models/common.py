"""Shared numerics of the port's LM path: the twins of
``src/repro/models/common.py``.

Parameters are plain nested dicts of tensors, in the reference's tree
layout, so that a tree carried across with ``interop.params_from_numpy``
maps key for key. Initialisers draw from an explicit ``torch.Generator``
on the device the tensors are made on; they follow the reference's
distributions, not its random bits.
"""
from __future__ import annotations

import torch
import torch.utils.checkpoint


def normal(gen: torch.Generator, shape, scale: float, dtype: torch.dtype) -> torch.Tensor:
    """``N(0, 1) * scale`` drawn in f32 on ``gen``'s device, as the
    reference's ``normal`` draws it."""
    return torch.randn(shape, generator=gen, device=gen.device,
                       dtype=torch.float32).to(dtype) * scale


def uniform(gen: torch.Generator, shape, lo: float = 0.0, hi: float = 1.0) -> torch.Tensor:
    """``U(lo, hi)`` in f32 on ``gen``'s device."""
    u = torch.rand(shape, generator=gen, device=gen.device, dtype=torch.float32)
    return u * (hi - lo) + lo


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps)
    return (out * scale.float()).to(x.dtype)


def rope_freqs(dim: int, theta: float = 10000.0, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10000.0) -> torch.Tensor:
    """x: (..., L, D) with D even; positions: (..., L) int.

    Interleaved pairs, as the reference rotates them: (x[2i], x[2i+1]) is
    the i-th pair, not (x[i], x[i + D/2])."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)                 # (d/2,)
    ang = positions[..., None].float() * freqs             # (..., L, d/2)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., ::2], x[..., 1::2]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    return torch.stack([y1, y2], dim=-1).reshape(x.shape).to(x.dtype)


def silu(x: torch.Tensor) -> torch.Tensor:
    """``x * sigmoid(x)``, as ``jax.nn.silu`` writes it."""
    return x * torch.sigmoid(x)


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``log(1 + e^x)`` as ``jax.nn.softplus`` computes it (``logaddexp(x,
    0)``); ``torch.nn.functional.softplus`` returns ``x`` above 20."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def swiglu(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    return silu(gate.float()).to(gate.dtype) * up


def stack_layers(n: int, init_one) -> dict:
    """Initialise ``n`` layers and stack every leaf along a new axis 0 (the
    reference's scan layout)."""
    trees = [init_one() for _ in range(n)]
    return _stack(trees)


def _stack(trees):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def unstack(tree, n: int) -> list:
    """The ``n`` layers of a stacked tree as ``n`` trees of views: one
    ``unbind`` per leaf, whose backward stacks the layers' gradients in one
    operation (indexing each layer would add a full-size zero gradient per
    layer)."""
    if isinstance(tree, dict):
        parts = {k: unstack(v, n) for k, v in tree.items()}
        return [{k: parts[k][i] for k in tree} for i in range(n)]
    return list(torch.unbind(tree, 0))


def remat(fn, enabled: bool, policy: str = "full"):
    """``fn`` rematerialised in the backward (``torch.utils.checkpoint``,
    non-reentrant) when ``enabled`` and autograd records; ``fn`` itself
    otherwise."""
    if not enabled:
        return fn
    if policy != "full":
        raise NotImplementedError(
            f"remat_policy {policy!r}: only 'full' is ported; saving the matmul outputs "
            "('dots') waits in ROADMAP queue 1, item 9")

    def wrapped(*args):
        if not torch.is_grad_enabled():
            return fn(*args)
        return torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False)

    return wrapped


def layer(tree, i: int):
    """Layer ``i`` of a stacked tree: every leaf indexed on axis 0 (views)."""
    if isinstance(tree, dict):
        return {k: layer(v, i) for k, v in tree.items()}
    return tree[i]
