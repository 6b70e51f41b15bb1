"""The Mamba2 SSD chunk scan as hand-written CUDA kernels on the tensor
cores.

Counterpart of the Pallas TPU kernel
``src/repro/kernels/ssd.py::ssd_chunk_scan``. The kernels are in
``csrc/ssd.cu`` (its header says what bounds them on the H100 and how the
design answers that); :func:`ssd_chunk_scan` checks the arguments, plans
the chunks, allocates the outputs and the chunk-state buffer, builds the
kernels at first use and launches them on PyTorch's current stream: one
call makes two device launches (the chunk states, then y). Its plain
version is the chunked twin :func:`repro_torch.kernels.ref.ssd`, used only
for tensors that lie on the CPU.

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

# Calls that launched the CUDA kernels (two device launches each);
# :func:`ssd_chunk_scan` adds one where it launches, and nowhere else.
launches = 0

# Steps of the kernels' chunk tile. A longer chunk runs as chunks of this
# many steps: the same function, summed in another order.
KERNEL_CHUNK = 64
_TILE = 64   # p columns of an output block (csrc/ssd.cu's kTile)
# Shared memory a block may use on Hopper (232,448 bytes).
MAX_SMEM = 232448
_MAX_GRID_Z = 65535

_ARGTYPES = [ctypes.c_void_p] * 10 + [ctypes.c_int64] * 9 + [ctypes.c_void_p]


@functools.cache
def library() -> build.Library:
    return build.Library("ssd", build.read_source(SOURCE), _ARGTYPES)


def pick_chunk(L: int, chunk: int) -> int:
    """The TPU kernel's chunk: ``min(chunk, L)``, halved until it divides L."""
    cs = min(chunk, L)
    while cs > 1 and L % cs:
        cs //= 2
    return max(cs, 1)


def plan(L: int, chunk: int) -> tuple[int, int]:
    """(cs, nc): the kernels' chunk, ``chunk`` but at most
    :data:`KERNEL_CHUNK`, and the number of chunks, the last one short
    where cs does not divide L. The kernels take a short last chunk, so
    they keep whole tiles where :func:`pick_chunk` would halve the chunk
    (to 1 for an odd L): the same function, summed in another order."""
    cs = max(1, min(chunk, KERNEL_CHUNK))
    return cs, -(-L // cs)


def smem_bytes(N: int) -> int:
    """Shared memory of one block of the output kernel at state size N
    (``csrc/ssd.cu``'s ``out_smem_bytes``: x, B, C, the start state, dt
    and the log decay; N padded to 16)."""
    npad = -(-N // 16) * 16
    return 4 * (KERNEL_CHUNK * (_TILE + 4) + 2 * KERNEL_CHUNK * npad + _TILE * (npad + 4)
                + 2 * KERNEL_CHUNK)


def ssd_chunk_scan(x, dt, A, Bm, Cm, D=None, h0=None, chunk: int = 64):
    """x (B, L, H, P); dt (B, L, H) positive; A (H,) negative; Bm/Cm
    (B, L, G, N) per state group (G divides H); D (H,) or None; h0
    (B, H, P, N) or None. Returns (y (B, L, H, P), h_final (B, H, P, N) f32).

    CUDA tensors run the kernels (at :func:`plan`'s chunk); CPU tensors run
    the plain version at :func:`pick_chunk`'s."""
    global launches
    Bb, L, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    if all_on_cpu(x, dt, A, Bm, Cm, D, h0):
        return ref.ssd(x, dt, A, Bm, Cm, D=D, h0=h0, chunk=pick_chunk(L, chunk))
    if G < 1 or H % G:
        raise ValueError(f"ssd: the groups G={G} must divide the heads H={H}")
    args = {"x": (x, (Bb, L, H, P)), "dt": (dt, (Bb, L, H)), "A": (A, (H,)),
            "Bm": (Bm, (Bb, L, G, N)), "Cm": (Cm, (Bb, L, G, N))}
    if D is not None:
        args["D"] = (D, (H,))
    if h0 is not None:
        args["h0"] = (h0, (Bb, H, P, N))
    smem = smem_bytes(N)
    if smem > MAX_SMEM or Bb * H > _MAX_GRID_Z:
        raise ValueError(f"ssd: N={N} needs {smem} bytes of shared memory (at most "
                         f"{MAX_SMEM}); B * H = {Bb * H} (at most {_MAX_GRID_Z})")
    dev = check_cuda_tensors(args, "ssd")
    cs, nc = plan(L, chunk)
    y = torch.empty_like(x)
    h_final = torch.empty((Bb, H, P, N), dtype=torch.float32, device=x.device)
    # each chunk's start state, (B, nc, H, P, N): written by the first
    # launch, read by the second
    states = torch.empty((Bb, nc, H, P, N), dtype=torch.float32, device=x.device)
    vec4 = P % 4 == 0 and N % 4 == 0 and all(
        t.data_ptr() % 16 == 0 for t in (x, Bm, Cm, h0) if t is not None)
    with torch.cuda.device(dev):
        library().launch(y.data_ptr(), h_final.data_ptr(), states.data_ptr(), x.data_ptr(),
                         dt.data_ptr(), A.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
                         None if D is None else D.data_ptr(),
                         None if h0 is None else h0.data_ptr(),
                         Bb, L, H, P, G, N, cs, nc, int(vec4), stream_of(dev))
    launches += 1
    return y, h_final
