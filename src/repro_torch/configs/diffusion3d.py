"""The paper's own experiment configs (Fig. 1 / Fig. 2 3-D heat diffusion).

``FIG1`` matches the listing in the paper: a 512^3 grid, lam = 1, c0 = 2,
the unit cube, dt = min(dx,dy,dz)^2 / (lam/c0) / 6.1, nt = 100. Smaller
variants for quick runs.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Diffusion3DConfig:
    nx: int = 512
    ny: int = 512
    nz: int = 512
    lx: float = 1.0
    ly: float = 1.0
    lz: float = 1.0
    lam: float = 1.0        # thermal conductivity
    c0: float = 2.0         # heat capacity
    nt: int = 100           # time steps
    dtype: str = "float32"
    init_temp: float = 1.7

    @property
    def shape(self):
        return (self.nx, self.ny, self.nz)


FIG1 = Diffusion3DConfig()
BENCH_256 = dataclasses.replace(FIG1, nx=256, ny=256, nz=256, nt=20)
SMOKE = dataclasses.replace(FIG1, nx=32, ny=32, nz=32, nt=5)
