"""The explicit Fig. 1 diffusion step as a hand-written CUDA kernel.

Counterpart of the Pallas TPU kernel
``src/repro/kernels/diffusion3d.py::diffusion3d_step``. The kernel is
``csrc/diffusion3d.cu`` (its header says what bounds it on the H100 and how
its design answers that); :func:`diffusion3d_step` checks the arguments,
builds the kernel at first use and launches it on PyTorch's current stream.
Its plain version is :func:`repro_torch.kernels.ref.diffusion3d_step`, used
only for tensors that lie on the CPU.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import build, ref
from .codegen import KernelShape
from .stencil import Launch, check_cuda_fields, derive_launch, stream_of

SOURCE = build.CSRC_DIR / "diffusion3d.cu"

# Launches of the CUDA kernel; :func:`diffusion3d_step` adds one where it
# launches, and nowhere else.
launches = 0

_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_float] * 5 + [ctypes.c_int64] * 7
             + [ctypes.c_void_p])


def column_launch(shape: tuple[int, int, int], n_sm: int) -> Launch:
    """Blocks of 32 (z) x 8 (y) threads, each thread marching ``xc`` planes
    along x, in about 4 waves of the SMs' 8 resident blocks."""
    return derive_launch(shape, n_sm, KernelShape((32, 8), 1, 8), waves=4)


@functools.cache
def library() -> build.Library:
    return build.Library("diffusion3d", build.read_source(SOURCE), _ARGTYPES)


def diffusion3d_step(T2, T, Ci, lam, dt, inv_dx, inv_dy, inv_dz, nsteps: int = 1):
    """One explicit Euler step of the Fig. 1 heat equation; returns a new
    tensor (the update on the interior, T2's values on the boundary ring).

    CUDA tensors run the kernel; CPU tensors run the plain version. The
    scalars are squared here in Python double, as the plain version squares
    them, and reach the kernel as f32."""
    global launches
    if int(nsteps) != 1:
        raise NotImplementedError(
            "nsteps > 1 is not ported yet (ROADMAP queue 1, item 3: run_steps(k) "
            "for both kernels)"
        )
    fields = {"T2": T2, "T": T, "Ci": Ci}
    if all(t.device.type == "cpu" for t in fields.values()):
        return ref.diffusion3d_step(T2, T, Ci, lam, dt, inv_dx, inv_dy, inv_dz)
    if T.dim() != 3 or min(T.shape) < 3:
        raise ValueError(f"T must be 3-D with every extent >= 3, got {tuple(T.shape)}")
    dev = check_cuda_fields(fields, T.shape)
    launch = column_launch(tuple(T.shape), torch.cuda.get_device_properties(dev)
                           .multi_processor_count)
    out = torch.empty_like(T)
    lib = library()
    with torch.cuda.device(dev):
        lib.launch(out.data_ptr(), T2.data_ptr(), T.data_ptr(), Ci.data_ptr(),
                   float(lam), float(dt), float(inv_dx ** 2), float(inv_dy ** 2),
                   float(inv_dz ** 2), *T.shape, launch.xc, *launch.grid,
                   stream_of(dev))
    launches += 1
    return out
