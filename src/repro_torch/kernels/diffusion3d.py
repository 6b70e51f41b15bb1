"""The explicit Fig. 1 diffusion step as a hand-written CUDA kernel.

Counterpart of the Pallas TPU kernel
``src/repro/kernels/diffusion3d.py::diffusion3d_step``, with its ``nsteps``
(k steps in one launch) and ``alias`` (the result in T2's buffer). The
kernel is ``csrc/diffusion3d.cu`` (its header says what bounds it on the
H100 and how its design answers that); :func:`diffusion3d_step` checks the
arguments, builds the kernel at first use and launches it on PyTorch's
current stream. Its plain version is
:func:`repro_torch.kernels.ref.diffusion3d_steps`, used only for tensors
that lie on the CPU.

Fields may be f32, bf16 or f16 (all four of one dtype). As in the
reference, whose kernel computes at the fields' dtype, a bf16 or f16 step
computes at that dtype: the scalars are rounded to it first
(:func:`ref.stored_scalars`) and every operation rounds to it.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import build, ref
from .codegen import KernelShape
from .stencil import (STEPS_WAVES, STORAGE_DTYPES, Launch, check_cuda_fields, derive_launch,
                      stream_of)

SOURCE = build.CSRC_DIR / "diffusion3d.cu"

# Launches of the CUDA kernel; :func:`diffusion3d_step` adds one where it
# launches, and nowhere else.
launches = 0

_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_float] * 5 + [ctypes.c_int64] * 9
             + [ctypes.c_void_p])
_BLOCK = (32, 8)            # threads along (z, y) of the single step, as in the source
_STEPS_SHAPE = (32, 16), 2  # the k-step kernel's tile and planes per step
_SLOTS = 4                  # planes per queue of the k-step kernel
MAX_STEPS = 4               # the largest nsteps the kernel takes (kMaxSteps)


def shared_bytes(nsteps: int, itemsize: int = 4) -> int:
    """Shared memory of one block of the k-step kernel: queue q < k of
    ``itemsize``-byte stored values over the tile and ``k - q`` cells of
    halo per side (0 for one step)."""
    if nsteps == 1:
        return 0
    (bz, by), _ = _STEPS_SHAPE
    return itemsize * _SLOTS * sum((by + 2 * (nsteps - q)) * (bz + 2 * (nsteps - q))
                                   for q in range(nsteps))


def column_launch(shape: tuple[int, int, int], n_sm: int, nsteps: int = 1,
                  itemsize: int = 4) -> Launch:
    """One step: blocks of 32 (z) x 8 (y) threads, each thread marching ``xc``
    planes along x, in about 4 waves of the SMs' 8 resident blocks. k steps:
    blocks of 32 x 16 threads marching two planes per step, in about
    ``stencil.STEPS_WAVES`` waves of the blocks the queues let reside, each
    chunk first computing ``2 k`` planes ahead of its own."""
    if nsteps == 1:
        return derive_launch(shape, n_sm, KernelShape(_BLOCK, 1, 8), waves=4)
    tile, planes = _STEPS_SHAPE
    resident = max(1, min(2, 232448 // shared_bytes(nsteps, itemsize)))
    return derive_launch(shape, n_sm, KernelShape(tile, planes, resident), lag=2 * nsteps,
                         waves=STEPS_WAVES)


@functools.cache
def library() -> build.Library:
    return build.Library("diffusion3d", build.read_source(SOURCE), _ARGTYPES)


def _shares_storage(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.untyped_storage().data_ptr() == b.untyped_storage().data_ptr()


def diffusion3d_step(T2, T, Ci, lam, dt, inv_dx, inv_dy, inv_dz, nsteps: int = 1,
                     alias: bool | None = None):
    """``nsteps`` explicit Euler steps of the Fig. 1 heat equation in one
    launch: the update on the interior, T2's values on the boundary ring
    (intermediate steps keep T's ring, as the reference does; the result
    equals ``nsteps`` rotated single steps when T2 and T agree there).

    ``alias=True`` writes the result into T2's buffer and returns it (the
    reference donates T2's buffer); T2 must not share storage with T or Ci.
    By default (``None``) the result aliases T2 on the card and is a new
    tensor on the CPU, as the reference aliases on its accelerator only.

    CUDA tensors run the kernel (``nsteps`` at most ``MAX_STEPS``); CPU
    tensors run the plain version. The scalars are squared here in Python
    double, as the plain version squares them, then rounded to the fields'
    dtype (``ref.stored_scalars``), and reach the kernel as f32."""
    global launches
    nsteps = int(nsteps)
    if nsteps < 1:
        raise ValueError(f"nsteps must be >= 1, got {nsteps}")
    fields = {"T2": T2, "T": T, "Ci": Ci}
    on_cpu = all(t.device.type == "cpu" for t in fields.values())
    alias = (not on_cpu) if alias is None else bool(alias)
    if alias and (_shares_storage(T2, T) or _shares_storage(T2, Ci)):
        raise ValueError("alias=True writes into T2's buffer, which must not share "
                         "storage with T or Ci")
    if on_cpu:
        out = ref.diffusion3d_steps(T2, T, Ci, lam, dt, inv_dx, inv_dy, inv_dz, nsteps)
        return T2.copy_(out) if alias else out
    if T.dim() != 3 or min(T.shape) < 3:
        raise ValueError(f"T must be 3-D with every extent >= 3, got {tuple(T.shape)}")
    if T.dtype not in STORAGE_DTYPES:
        raise TypeError(f"T is {T.dtype}; the CUDA kernel takes float32, bfloat16 or float16")
    dev = check_cuda_fields(fields, T.shape, T.dtype)
    if nsteps > MAX_STEPS:
        raise NotImplementedError(
            f"nsteps={nsteps}: the kernel takes at most {MAX_STEPS} steps per launch, "
            "the steps the card checks")
    launch = column_launch(tuple(T.shape), torch.cuda.get_device_properties(dev)
                           .multi_processor_count, nsteps, T.element_size())
    out = T2 if alias else torch.empty_like(T)
    lib = library()
    with torch.cuda.device(dev):
        lib.launch(out.data_ptr(), T2.data_ptr(), T.data_ptr(), Ci.data_ptr(),
                   *ref.stored_scalars(T.dtype, lam, dt, inv_dx, inv_dy, inv_dz), *T.shape,
                   launch.xc, nsteps, STORAGE_DTYPES.index(T.dtype), *launch.grid,
                   stream_of(dev))
    launches += 1
    return out
