"""Declarative field allocation (the paper's ``@ones``/``@zeros`` macros).

:class:`FieldSet` binds a grid, a dtype, a layout and a device, and hands
out plain ``torch.Tensor`` fields of the grid's shape on that device.
Logical vector fields (:class:`VectorField`, :meth:`FieldSet.vector`) are
allocated either as SoA, a tuple of component tensors (each component
contiguous along the grid's last axis, the layout the generated kernels
load coalesced), or AoS, one tensor with a trailing component axis.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import torch

from .device import resolve_device
from .grid import Grid

LAYOUTS = ("soa", "aos")


@dataclasses.dataclass
class VectorField:
    """A logical array-of-structs field in a chosen memory layout:
    ``components`` is a tuple of tensors (``"soa"``) or one tensor with a
    trailing component axis (``"aos"``)."""

    components: tuple[torch.Tensor, ...] | torch.Tensor
    layout: str  # "soa" | "aos"

    def __getitem__(self, i: int) -> torch.Tensor:
        if self.layout == "soa":
            return self.components[i]
        return self.components[..., i]

    @property
    def ncomp(self) -> int:
        if self.layout == "soa":
            return len(self.components)
        return self.components.shape[-1]

    def as_soa(self) -> "VectorField":
        """The SoA form: each component copied out contiguous."""
        if self.layout == "soa":
            return self
        return VectorField(tuple(self.components[..., i].contiguous()
                                 for i in range(self.ncomp)), "soa")

    def as_aos(self) -> "VectorField":
        if self.layout == "aos":
            return self
        return VectorField(torch.stack(self.components, dim=-1), "aos")

    def map(self, fn: Callable[[torch.Tensor], torch.Tensor]) -> "VectorField":
        if self.layout == "soa":
            return VectorField(tuple(fn(c) for c in self.components), "soa")
        return VectorField(fn(self.components), "aos")


class FieldSet:
    """Allocator bound to a grid, a dtype, a vector layout and a device (the
    card by default)."""

    def __init__(self, grid: Grid | Sequence[int], dtype: torch.dtype = torch.float32,
                 device="cuda", layout: str = "soa"):
        if not isinstance(grid, Grid):
            grid = Grid(tuple(grid))
        if layout not in LAYOUTS:
            raise ValueError(f"layout must be 'soa' or 'aos', got {layout!r}")
        self.grid = grid
        self.dtype = dtype
        self.layout = layout
        self.device = resolve_device(device)
        self._registry: dict[str, torch.Tensor | VectorField] = {}

    def zeros(self, name: str | None = None) -> torch.Tensor:
        return self._scalar(name, torch.zeros(self.grid.shape, dtype=self.dtype,
                                              device=self.device))

    def ones(self, name: str | None = None) -> torch.Tensor:
        return self._scalar(name, torch.ones(self.grid.shape, dtype=self.dtype,
                                             device=self.device))

    def full(self, value, name: str | None = None) -> torch.Tensor:
        return self._scalar(name, torch.full(self.grid.shape, value, dtype=self.dtype,
                                             device=self.device))

    def rand(self, generator: torch.Generator, name: str | None = None) -> torch.Tensor:
        """Uniform values in [0, 1), drawn from ``generator`` on its own
        device at this set's dtype, then placed on this set's device: the
        same generator state gives the same field."""
        u = torch.rand(self.grid.shape, generator=generator, dtype=self.dtype,
                       device=generator.device)
        return self._scalar(name, u.to(self.device))

    def from_fn(self, fn: Callable[..., torch.Tensor], name: str | None = None) -> torch.Tensor:
        """Initialize from a function of the physical coordinates."""
        xs = self.grid.meshgrid(self.dtype, self.device)
        return self._scalar(name, fn(*xs).to(self.dtype))

    def _scalar(self, name, arr) -> torch.Tensor:
        if name:
            self._registry[name] = arr
        return arr

    def vector(self, ncomp: int, init=0.0, name: str | None = None,
               layout: str | None = None) -> VectorField:
        """A vector field of ``ncomp`` components filled with ``init``, in
        ``layout`` (by default this set's)."""
        layout = layout or self.layout
        if layout not in LAYOUTS:
            raise ValueError(f"layout must be 'soa' or 'aos', got {layout!r}")
        if layout == "soa":
            vf = VectorField(tuple(torch.full(self.grid.shape, init, dtype=self.dtype,
                                              device=self.device) for _ in range(ncomp)), "soa")
        else:
            vf = VectorField(torch.full((*self.grid.shape, ncomp), init, dtype=self.dtype,
                                        device=self.device), "aos")
        if name:
            self._registry[name] = vf
        return vf

    def __getitem__(self, name: str):
        return self._registry[name]

    def names(self) -> list[str]:
        return list(self._registry)

    def nbytes(self) -> int:
        total = 0
        for v in self._registry.values():
            arrs = ((v.components if v.layout == "soa" else (v.components,))
                    if isinstance(v, VectorField) else (v,))
            total += sum(a.numel() * a.element_size() for a in arrs)
        return total
