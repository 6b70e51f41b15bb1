"""Cartesian grid description for stencil computations.

Arrays carry their boundary points; stencil kernels update the interior
(``@inn``) region only. A :class:`Grid` records the global array extent,
the physical spacing and the stencil radius, so that launch parameters and
T_eff accounting derive from one object.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import torch

from .device import resolve_device


@dataclasses.dataclass(frozen=True)
class Grid:
    """A structured grid with uniform spacing.

    Attributes:
      shape: number of grid points per axis, boundary included
        (the paper's ``nx, ny, nz``).
      length: physical domain extent per axis (the paper's ``lx, ly, lz``).
      radius: stencil halo width in points. 1 for 2nd-order FD.
    """

    shape: tuple[int, ...]
    length: tuple[float, ...] = ()
    radius: int = 1

    def __post_init__(self):
        object.__setattr__(self, "shape", tuple(int(s) for s in self.shape))
        if not self.length:
            object.__setattr__(self, "length", tuple(1.0 for _ in self.shape))
        object.__setattr__(self, "length", tuple(float(l) for l in self.length))
        if len(self.length) != len(self.shape):
            raise ValueError(f"length {self.length} incompatible with shape {self.shape}")
        if any(s < 2 * self.radius + 1 for s in self.shape):
            raise ValueError(f"shape {self.shape} too small for radius {self.radius}")

    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def spacing(self) -> tuple[float, ...]:
        """Physical distance between adjacent points (``dx = lx/(nx-1)``)."""
        return tuple(l / (s - 1) for l, s in zip(self.length, self.shape))

    @property
    def inv_spacing(self) -> tuple[float, ...]:
        return tuple(1.0 / d for d in self.spacing)

    @property
    def n_points(self) -> int:
        return math.prod(self.shape)

    @property
    def interior_shape(self) -> tuple[int, ...]:
        return tuple(s - 2 * self.radius for s in self.shape)

    @property
    def interior_slice(self) -> tuple[slice, ...]:
        r = self.radius
        return tuple(slice(r, s - r) for s in self.shape)

    def coords(self, dtype=torch.float32, device="cuda") -> tuple[torch.Tensor, ...]:
        """Per-axis coordinate vectors (including boundary points).

        Point ``i < s-1`` is ``i * (l * (1/(s-1)))`` rounded at ``dtype`` and
        the last point is ``l``: the values ``jnp.linspace(0, l, s)`` gives
        on the CPU, so both packages start from the same coordinates."""
        device = resolve_device(device)
        out = []
        for l, s in zip(self.length, self.shape):
            step = torch.tensor(l, dtype=dtype) * (1 / torch.tensor(s - 1, dtype=dtype))
            pts = torch.arange(s - 1, dtype=dtype) * step
            out.append(torch.cat([pts, torch.tensor([l], dtype=dtype)]).to(device))
        return tuple(out)

    def meshgrid(self, dtype=torch.float32, device="cuda") -> tuple[torch.Tensor, ...]:
        return tuple(torch.meshgrid(*self.coords(dtype, device), indexing="ij"))

    def stable_diffusion_dt(self, diffusivity: float, safety: float = 6.1) -> float:
        """The paper's explicit-diffusion time-step bound (Fig. 1, line 33)."""
        return min(d ** 2 for d in self.spacing) / diffusivity / safety

    def subgrid(self, factors: Sequence[int]) -> "Grid":
        """Local grid for one rank of a block domain decomposition.

        The local array keeps one halo layer of width ``radius`` on every
        face (interior sizes must divide evenly).
        """
        if len(factors) != self.ndim:
            raise ValueError("one decomposition factor per axis required")
        r = self.radius
        local = []
        for s, f in zip(self.shape, factors):
            inner = s - 2 * r
            if inner % f:
                raise ValueError(f"interior extent {inner} not divisible by {f}")
            local.append(inner // f + 2 * r)
        return Grid(tuple(local), tuple(l / f for l, f in zip(self.length, factors)), r)


def volume_bytes(shape: Sequence[int], dtype: torch.dtype) -> int:
    return math.prod(shape) * dtype.itemsize


def human_bytes(n: float) -> str:
    for unit in ("B", "KiB", "MiB", "GiB", "TiB"):
        if abs(n) < 1024.0 or unit == "TiB":
            return f"{n:.2f} {unit}"
        n /= 1024.0
    return f"{n:.2f} TiB"
