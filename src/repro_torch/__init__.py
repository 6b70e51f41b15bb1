"""repro_torch — the xPU stencil system in PyTorch, with hand-written CUDA
kernels for Hopper (sm_90a).

The JAX package ``repro`` is the reference this port is held against; this
package imports neither ``jax`` nor ``repro``. Entry points run on the card
(``device="cuda"``) unless the caller asks for the CPU, where every kernel
wrapper uses its plain PyTorch version.
"""
__version__ = "0.1.0"
