"""Initial conditions for the physics solvers."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core.grid import Grid


def gaussian_hotspot(grid: Grid, amplitude: float = 1.0, width: float = 0.1,
                     background: float = 0.0, dtype=torch.float32, device="cuda"):
    """Centered Gaussian temperature anomaly."""
    xs = grid.meshgrid(dtype, device)
    c = [l / 2 for l in grid.length]
    r2 = sum((x - ci) ** 2 for x, ci in zip(xs, c))
    return background + amplitude * torch.exp(-r2 / (2 * width ** 2))


def random_porosity(generator: torch.Generator, grid: Grid, mean: float = 0.1,
                    contrast: float = 2.0, dtype=torch.float32, device="cuda"):
    """Smooth random porosity field for the two-phase flow solver: a uniform
    draw from ``generator`` (on its own device, then placed on ``device``)
    smoothed by :func:`smooth_porosity`."""
    phi = torch.rand(grid.shape, generator=generator, dtype=dtype, device=generator.device)
    return smooth_porosity(phi.to(device), mean, contrast)


def smooth_porosity(phi: torch.Tensor, mean: float = 0.1, contrast: float = 2.0):
    """Three passes of nearest-neighbour averaging of a uniform field (edge
    values repeated past the boundary), scaled to ``mean`` with relative
    spread ``contrast``."""
    nd = phi.dim()
    for _ in range(3):
        pad = F.pad(phi[None, None], (1, 1) * nd, mode="replicate")[0, 0]
        acc = torch.zeros_like(phi)
        for ax in range(nd):
            lo = tuple(slice(0, -2) if a == ax else slice(1, -1) for a in range(nd))
            hi = tuple(slice(2, None) if a == ax else slice(1, -1) for a in range(nd))
            acc = acc + pad[lo] + pad[hi]
        phi = (phi + acc / (2 * nd)) / 2
    return mean * (1 + contrast * (phi - phi.mean()))


def vortex_wavefunction(grid: Grid, n_vortices: int = 2, dtype=torch.complex64, device="cuda"):
    """Initial condition for the Gross-Pitaevskii solver: a uniform
    condensate with phase windings (quantized vortices) along z."""
    xs = grid.meshgrid(torch.float32, device)
    cx, cy = grid.length[0] / 2, grid.length[1] / 2
    phase = torch.zeros(grid.shape, dtype=torch.float32, device=device)
    for i in range(n_vortices):
        ox = cx + (i - (n_vortices - 1) / 2) * grid.length[0] / (n_vortices + 1)
        phase = phase + torch.atan2(xs[1] - cy, xs[0] - ox)
    amp = torch.ones(grid.shape, dtype=torch.float32, device=device)
    return (amp * torch.exp(1j * phase)).to(dtype)
