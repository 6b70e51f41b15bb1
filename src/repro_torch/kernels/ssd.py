"""The Mamba2 SSD chunk scan as a hand-written CUDA kernel.

Counterpart of the Pallas TPU kernel
``src/repro/kernels/ssd.py::ssd_chunk_scan``. The kernel is ``csrc/ssd.cu``
(its header says what bounds it on the H100 and how its design answers
that); :func:`ssd_chunk_scan` checks the arguments, builds the kernel at
first use and launches it on PyTorch's current stream. Its plain version is
the chunked twin :func:`repro_torch.kernels.ref.ssd`, used only for tensors
that lie on the CPU.

Unlike the TPU kernel, it takes B and C per state group (B, L, G, N) and
reads each head's group itself, so nothing is broadcast to heads first.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import build, ref
from .args import all_on_cpu, check_cuda_tensors
from .stencil import stream_of

SOURCE = build.CSRC_DIR / "ssd.cu"

# Launches of the CUDA kernel; :func:`ssd_chunk_scan` adds one where it
# launches, and nowhere else.
launches = 0

# Shared memory a block may use on Hopper (232,448 bytes).
MAX_SMEM = 232448
_MAX_GRID_Y = 65535

_ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.c_int64] * 7 + [ctypes.c_void_p]


@functools.cache
def library() -> build.Library:
    return build.Library("ssd", SOURCE.read_text(), _ARGTYPES)


def pick_chunk(L: int, chunk: int) -> int:
    """The TPU kernel's chunk: ``min(chunk, L)``, halved until it divides L."""
    cs = min(chunk, L)
    while cs > 1 and L % cs:
        cs //= 2
    return max(cs, 1)


def smem_bytes(P: int, N: int, cs: int) -> int:
    """Shared memory of one block (``csrc/ssd.cu``'s layout)."""
    return 4 * (cs * P + N * (cs + 1) + cs * N + cs * cs + N * (P + 1) + 4 * cs)


def ssd_chunk_scan(x, dt, A, Bm, Cm, D=None, h0=None, chunk: int = 64):
    """x (B, L, H, P); dt (B, L, H) positive; A (H,) negative; Bm/Cm
    (B, L, G, N) per state group (G divides H); D (H,) or None; h0
    (B, H, P, N) or None. Returns (y (B, L, H, P), h_final (B, H, P, N) f32).

    CUDA tensors run the kernel; CPU tensors run the plain version at the
    same chunk."""
    global launches
    Bb, L, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    cs = pick_chunk(L, chunk)
    if all_on_cpu(x, dt, A, Bm, Cm, D, h0):
        return ref.ssd(x, dt, A, Bm, Cm, D=D, h0=h0, chunk=cs)
    if G < 1 or H % G:
        raise ValueError(f"ssd: the groups G={G} must divide the heads H={H}")
    args = {"x": (x, (Bb, L, H, P)), "dt": (dt, (Bb, L, H)), "A": (A, (H,)),
            "Bm": (Bm, (Bb, L, G, N)), "Cm": (Cm, (Bb, L, G, N))}
    if D is not None:
        args["D"] = (D, (H,))
    if h0 is not None:
        args["h0"] = (h0, (Bb, H, P, N))
    dev = check_cuda_tensors(args, "ssd")
    smem = smem_bytes(P, N, cs)
    if smem > MAX_SMEM or Bb > _MAX_GRID_Y:
        raise ValueError(f"ssd: P={P}, N={N}, chunk={cs} need {smem} bytes of shared "
                         f"memory (at most {MAX_SMEM}), B={Bb} (at most {_MAX_GRID_Y})")
    y = torch.empty_like(x)
    h_final = torch.empty((Bb, H, P, N), dtype=torch.float32, device=x.device)
    with torch.cuda.device(dev):
        library().launch(y.data_ptr(), h_final.data_ptr(), x.data_ptr(), dt.data_ptr(),
                         A.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
                         None if D is None else D.data_ptr(),
                         None if h0 is None else h0.data_ptr(),
                         Bb, L, H, P, G, N, cs, stream_of(dev))
    launches += 1
    return y, h_final
