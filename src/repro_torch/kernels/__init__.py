"""Hand-written CUDA kernels for the hot spots, their plain PyTorch versions
in ref.py, and the public entry points in ops.py."""
from . import codegen, diffusion3d, ops, ref, stencil

__all__ = ["codegen", "diffusion3d", "ops", "ref", "stencil"]
