"""Boundary-condition declarations for fused stencil launches.

A :class:`BoundaryCondition` is declared per output field on ``@parallel``
and realized by the engine itself: the ``torch`` backend applies the
``core.boundary`` post-pass after the write, and the generated CUDA kernel
computes the same face values inside its launch (``kernels/codegen.py``),
bitwise equal to that post-pass.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Sequence

__all__ = ["BoundaryCondition", "normalize_bcs"]

KINDS = ("dirichlet", "neumann0", "periodic")


@dataclasses.dataclass(frozen=True)
class BoundaryCondition:
    """One output field's boundary condition.

    ``axes=None`` means every axis (the ``core.boundary`` default);
    ``depth`` is the face thickness in cells; ``value`` only applies to
    ``dirichlet``.
    """

    kind: str
    value: float = 0.0
    axes: tuple[int, ...] | None = None
    depth: int = 1

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(
                f"boundary condition kind {self.kind!r} must be one of {KINDS}"
            )
        if self.depth < 1:
            raise ValueError(f"bc depth must be >= 1, got {self.depth}")
        if self.axes is not None:
            object.__setattr__(self, "axes", tuple(int(a) for a in self.axes))

    def resolved_axes(self, ndim: int) -> tuple[int, ...]:
        return tuple(range(ndim)) if self.axes is None else self.axes

    def apply(self, A):
        """The plain realization: the ``core.boundary`` post-pass."""
        from ..core import boundary  # lazy: core imports ir

        axes = self.resolved_axes(A.dim())
        if self.kind == "dirichlet":
            return boundary.dirichlet(A, self.value, axes=axes, depth=self.depth)
        if self.kind == "neumann0":
            return boundary.neumann0(A, axes=axes, depth=self.depth)
        return boundary.periodic(A, axes=axes, depth=self.depth)


def normalize_bcs(
    bc: Mapping[str, BoundaryCondition | str] | None,
    out_names: Sequence[str],
    ndim: int,
    field_shapes: Mapping[str, Sequence[int]] | None = None,
) -> dict[str, BoundaryCondition]:
    """Validate a per-output bc mapping; bare kind strings become
    default-parameter conditions. With ``field_shapes``, each face depth
    is checked against its output's extents."""
    if not bc:
        return {}
    out = {}
    for name, spec in bc.items():
        if name not in out_names:
            raise ValueError(
                f"boundary condition declared for {name!r}, which is not an "
                f"output of this kernel (outputs: {tuple(out_names)})"
            )
        if isinstance(spec, str):
            spec = BoundaryCondition(spec)
        if not isinstance(spec, BoundaryCondition):
            raise ValueError(
                f"bc[{name!r}] must be a BoundaryCondition or kind string, "
                f"got {type(spec).__name__}"
            )
        for a in spec.resolved_axes(ndim):
            if not 0 <= a < ndim:
                raise ValueError(f"bc[{name!r}] axis {a} out of range for ndim {ndim}")
        if field_shapes is not None and name in field_shapes:
            from ..core import boundary  # lazy: core imports ir

            boundary.check_depth(tuple(field_shapes[name]), spec.kind,
                                 spec.resolved_axes(ndim), spec.depth)
        out[name] = spec
    return out
