from .diffusion3d import BENCH_256, FIG1, SMOKE, Diffusion3DConfig

__all__ = ["BENCH_256", "FIG1", "SMOKE", "Diffusion3DConfig"]
