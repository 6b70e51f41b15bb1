"""Initial conditions for the physics solvers."""
from __future__ import annotations

import torch

from ..core.grid import Grid


def gaussian_hotspot(grid: Grid, amplitude: float = 1.0, width: float = 0.1,
                     background: float = 0.0, dtype=torch.float32, device="cuda"):
    """Centered Gaussian temperature anomaly."""
    xs = grid.meshgrid(dtype, device)
    c = [l / 2 for l in grid.length]
    r2 = sum((x - ci) ** 2 for x, ci in zip(xs, c))
    return background + amplitude * torch.exp(-r2 / (2 * width ** 2))
