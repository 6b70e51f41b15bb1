"""Core stencil engine of the port."""
from . import teff
from .fd import fd1d, fd2d, fd3d
from .fields import FieldSet, VectorField
from .grid import Grid
from .iterate import Checkpointing, SolveResult, make_solver, solve_until
from .parallel import ParallelStencil, StencilKernel, init_parallel_stencil

__all__ = [
    "Grid", "FieldSet", "VectorField", "fd1d", "fd2d", "fd3d",
    "ParallelStencil", "StencilKernel", "init_parallel_stencil",
    "Checkpointing", "SolveResult", "make_solver", "solve_until", "teff",
]
