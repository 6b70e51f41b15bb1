"""Boundary conditions for stencil fields, as a post-pass.

The counterparts of the boundary handling a ParallelStencil user writes as
small ``@parallel_indices`` kernels, and of ``repro.core.boundary``. Each
function returns a new tensor with the condition applied on the faces of
the given axes, axis by axis in the order given, the low face before the
high face; that order defines the corner values. The ``torch`` backend of
``@parallel`` applies them after each write; the generated CUDA kernel
computes the same values inside its launch and is held against them.
"""
from __future__ import annotations

from typing import Sequence

import torch


def check_depth(shape: Sequence[int], kind: str, axes: Sequence[int],
                depth: int) -> None:
    """Validate that every requested face fits the array.

    ``dirichlet`` needs two disjoint ``depth``-cell faces per axis
    (extent >= 2*depth); ``neumann0``/``periodic`` also need their source
    layers to be interior cells disjoint from both faces (extent >=
    3*depth). Raises ``ValueError`` otherwise.
    """
    if depth < 1:
        raise ValueError(f"boundary depth must be >= 1, got {depth}")
    need = 2 * depth if kind == "dirichlet" else 3 * depth
    for ax in axes:
        n = shape[ax]
        if n < need:
            raise ValueError(
                f"axis {ax} of extent {n} is smaller than the {depth}-deep "
                f"{kind} faces require (need >= {need}: two {depth}-cell "
                "faces" + ("" if kind == "dirichlet"
                           else " plus interior source layers") + ")"
            )


def _face(ndim: int, axis: int, side: int, depth: int = 1):
    sl = [slice(None)] * ndim
    sl[axis] = slice(0, depth) if side == 0 else slice(-depth, None)
    return tuple(sl)


def _inner_face(ndim: int, axis: int, side: int, depth: int = 1):
    sl = [slice(None)] * ndim
    sl[axis] = slice(depth, 2 * depth) if side == 0 else slice(-2 * depth, -depth)
    return tuple(sl)


def _axes(A: torch.Tensor, axes) -> tuple[int, ...]:
    return tuple(range(A.dim()) if axes is None else axes)


def dirichlet(A: torch.Tensor, value, axes: Sequence[int] | None = None,
              depth: int = 1) -> torch.Tensor:
    """Fix boundary faces to ``value`` (scalar or broadcastable)."""
    axes = _axes(A, axes)
    check_depth(A.shape, "dirichlet", axes, depth)
    A = A.clone()
    for ax in axes:
        for side in (0, 1):
            A[_face(A.dim(), ax, side, depth)] = value
    return A


def neumann0(A: torch.Tensor, axes: Sequence[int] | None = None,
             depth: int = 1) -> torch.Tensor:
    """Zero flux: copy the first interior layer onto the boundary layer."""
    axes = _axes(A, axes)
    check_depth(A.shape, "neumann0", axes, depth)
    A = A.clone()
    for ax in axes:
        for side in (0, 1):
            A[_face(A.dim(), ax, side, depth)] = A[_inner_face(A.dim(), ax, side, depth)]
    return A


def periodic(A: torch.Tensor, axes: Sequence[int] | None = None,
             depth: int = 1) -> torch.Tensor:
    """Wrap: boundary layers mirror the opposite interior layers."""
    axes = _axes(A, axes)
    check_depth(A.shape, "periodic", axes, depth)
    A = A.clone()
    for ax in axes:
        n = A.shape[ax]
        lo_src = [slice(None)] * A.dim()
        hi_src = [slice(None)] * A.dim()
        lo_src[ax] = slice(n - 2 * depth, n - depth)  # far interior -> low ghost
        hi_src[ax] = slice(depth, 2 * depth)          # near interior -> high ghost
        A[_face(A.dim(), ax, 0, depth)] = A[tuple(lo_src)]
        A[_face(A.dim(), ax, 1, depth)] = A[tuple(hi_src)]
    return A
