"""Hand-written CUDA kernels for the hot spots, their plain PyTorch versions
in ref.py, the public entry points in ops.py, and the launch autotuner of the
generated stencil kernel in autotune.py."""
from . import attention, codegen, conv1d, diffusion3d, ops, ref, ssd, stencil
from . import autotune

__all__ = ["attention", "autotune", "codegen", "conv1d", "diffusion3d", "ops", "ref", "ssd", "stencil"]
