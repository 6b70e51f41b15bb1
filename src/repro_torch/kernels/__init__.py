"""Hand-written CUDA kernels for the hot spots, their plain PyTorch versions
in ref.py, and the public entry points in ops.py."""
from . import attention, codegen, conv1d, diffusion3d, ops, ref, ssd, stencil

__all__ = ["attention", "codegen", "conv1d", "diffusion3d", "ops", "ref", "ssd", "stencil"]
