"""Math-close finite-difference operators (ParallelStencil.FiniteDifferences{1,2,3}D).

They are *relative* slice expressions, so the same kernel source works on
full tensors (the ``torch`` backend) and on the symbolic windows the stencil
tracer feeds through it (``ir.sym``), from which the ``cuda`` backend
generates its kernel.

Naming follows ParallelStencil:
  ``*_a``  operate over the full extent of the differentiated axis,
  ``*_i``  additionally restrict all *other* axes to their interior,
  ``inn``  selects the interior in all axes.
"""
from __future__ import annotations

import itertools

import torch

__all__ = ["fd1d", "fd2d", "fd3d", "FiniteDifferences"]


def _s(ndim: int, axis: int, sl: slice, other: slice) -> tuple[slice, ...]:
    return tuple(sl if a == axis else other for a in range(ndim))


_FULL = slice(None)
_INN = slice(1, -1)


class FiniteDifferences:
    """Finite-difference operator namespace for a fixed dimensionality."""

    def __init__(self, ndim: int):
        self.ndim = ndim
        for axis, name in enumerate("xyz"[:ndim]):
            setattr(self, f"d_{name}a", self._make(self._d, axis, inner_other=False))
            setattr(self, f"d_{name}i", self._make(self._d, axis, inner_other=True))
            setattr(self, f"d2_{name}a", self._make(self._d2, axis, inner_other=False))
            setattr(self, f"d2_{name}i", self._make(self._d2, axis, inner_other=True))
            setattr(self, f"av_{name}a", self._make(self._av, axis, inner_other=False))
            setattr(self, f"av_{name}i", self._make(self._av, axis, inner_other=True))

    # -- primitive stencils ------------------------------------------------
    def _d(self, A, axis, other):
        n = self.ndim
        return A[_s(n, axis, slice(1, None), other)] - A[_s(n, axis, slice(None, -1), other)]

    def _d2(self, A, axis, other):
        n = self.ndim
        return (
            A[_s(n, axis, slice(2, None), other)]
            - 2.0 * A[_s(n, axis, _INN, other)]
            + A[_s(n, axis, slice(None, -2), other)]
        )

    def _av(self, A, axis, other):
        n = self.ndim
        return 0.5 * (
            A[_s(n, axis, slice(1, None), other)] + A[_s(n, axis, slice(None, -1), other)]
        )

    def _make(self, op, axis, inner_other):
        other = _INN if inner_other else _FULL

        def f(A):
            return op(A, axis, other)
        f.__name__ = f"{op.__name__}_ax{axis}_{'i' if inner_other else 'a'}"
        return f

    # -- interior / neighborhood ops ---------------------------------------
    def inn(self, A):
        """Interior of A in every axis (the paper's ``@inn``)."""
        return A[(_INN,) * self.ndim]

    def av(self, A):
        """Average over the 2^ndim cell corners (the paper's ``@av``)."""
        out = A
        for axis in range(self.ndim):
            out = 0.5 * (
                out[_s(self.ndim, axis, slice(1, None), _FULL)]
                + out[_s(self.ndim, axis, slice(None, -1), _FULL)]
            )
        return out

    def maxloc(self, A):
        """Maximum over the 3^ndim neighborhood, evaluated on the interior
        (the paper/package's ``@maxloc``)."""
        out = None
        for offs in itertools.product(range(3), repeat=self.ndim):
            v = A[tuple(slice(o, None if o == 2 else o - 2) for o in offs)]
            out = v if out is None else torch.maximum(out, v)
        return out

    def laplacian(self, A, inv_spacing):
        """Sum of second differences on the interior, scaled by 1/d^2."""
        total = 0.0
        for axis, nm in enumerate("xyz"[: self.ndim]):
            total = total + getattr(self, f"d2_{nm}i")(A) * inv_spacing[axis] ** 2
        return total


fd1d = FiniteDifferences(1)
fd2d = FiniteDifferences(2)
fd3d = FiniteDifferences(3)
