"""Declarative field allocation (the paper's ``@ones``/``@zeros`` macros).

:class:`FieldSet` binds a grid, a dtype and a device, and hands out plain
``torch.Tensor`` fields of the grid's shape on that device.
"""
from __future__ import annotations

from typing import Callable, Sequence

import torch

from .device import resolve_device
from .grid import Grid


class FieldSet:
    """Allocator bound to a grid, a dtype and a device (the card by default)."""

    def __init__(self, grid: Grid | Sequence[int], dtype: torch.dtype = torch.float32,
                 device="cuda"):
        if not isinstance(grid, Grid):
            grid = Grid(tuple(grid))
        self.grid = grid
        self.dtype = dtype
        self.device = resolve_device(device)
        self._registry: dict[str, torch.Tensor] = {}

    def zeros(self, name: str | None = None) -> torch.Tensor:
        return self._scalar(name, torch.zeros(self.grid.shape, dtype=self.dtype,
                                              device=self.device))

    def ones(self, name: str | None = None) -> torch.Tensor:
        return self._scalar(name, torch.ones(self.grid.shape, dtype=self.dtype,
                                             device=self.device))

    def full(self, value, name: str | None = None) -> torch.Tensor:
        return self._scalar(name, torch.full(self.grid.shape, value, dtype=self.dtype,
                                             device=self.device))

    def from_fn(self, fn: Callable[..., torch.Tensor], name: str | None = None) -> torch.Tensor:
        """Initialize from a function of the physical coordinates."""
        xs = self.grid.meshgrid(self.dtype, self.device)
        return self._scalar(name, fn(*xs).to(self.dtype))

    def _scalar(self, name, arr) -> torch.Tensor:
        if name:
            self._registry[name] = arr
        return arr

    def __getitem__(self, name: str) -> torch.Tensor:
        return self._registry[name]

    def names(self) -> list[str]:
        return list(self._registry)

    def nbytes(self) -> int:
        return sum(v.numel() * v.element_size() for v in self._registry.values())
