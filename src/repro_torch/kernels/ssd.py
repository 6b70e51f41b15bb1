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

Training differentiates the kernels through :class:`SSDFn`: the forward
keeps its chunk-start states, and the backward is the hand-written
``csrc/ssd_bwd.cu`` (:func:`ssd_chunk_scan_bwd`; plain version
``ref.ssd_bwd``), at the forward's own chunk plan.

x, Bm and Cm (and y; in the backward dy, dx, dB and dC) are float32 or
bfloat16, one dtype a call, as the reference's kernel takes the parameter
dtype; dt, A, D, h0, the states and h_final (and their gradients) are
float32. Each dtype runs its own instance of the sources (``library(bf16)``),
which converts to f32 on load, computes in f32 and rounds once on store.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import build, ref
from .args import all_on_cpu, check_cuda_tensors
from .stencil import stream_of

SOURCE = build.CSRC_DIR / "ssd.cu"
BWD_SOURCE = build.CSRC_DIR / "ssd_bwd.cu"

# Calls that launched the CUDA kernels: :func:`ssd_chunk_scan` adds one to
# ``launches`` (two device launches each), :func:`ssd_chunk_scan_bwd` one to
# ``launches_bwd`` (four or five device launches: the chunk-state gradients,
# the chunks, the slices' fold where a group has more than one, dla and the
# fold over b), where they launch and nowhere else.
launches = 0
launches_bwd = 0

# Steps of the kernels' chunk tile. A longer chunk runs as chunks of this
# many steps: the same function, summed in another order.
KERNEL_CHUNK = 64
_TILE = 64   # p columns of an output block (csrc/ssd.cu's kTile)
# Shared memory a block may use on Hopper (232,448 bytes).
MAX_SMEM = 232448
_MAX_GRID_Z = 65535

# the backward's tiles hold at most 128 state columns
MAX_N_BWD = 128
_SMS = 132   # the H100 SXM's SMs (csrc/ssd_bwd.cu's kSMs)

_ARGTYPES = [ctypes.c_void_p] * 10 + [ctypes.c_int64] * 9 + [ctypes.c_void_p]
_BWD_ARGTYPES = [ctypes.c_void_p] * 18 + [ctypes.c_int64] * 9 + [ctypes.c_void_p]


# the arguments kept in float32 whatever the storage dtype
F32_ARGS = ("dt", "A", "D", "h0", "dh_final", "states", "h_final")


@functools.cache
def library(bf16: bool = False) -> build.Library:
    return build.Library(*build.instance("ssd", SOURCE, bf16), _ARGTYPES)


@functools.cache
def bwd_library(bf16: bool = False) -> build.Library:
    return build.Library(*build.instance("ssd_bwd", BWD_SOURCE, bf16), _BWD_ARGTYPES)


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


def ssd_chunk_scan(x, dt, A, Bm, Cm, D=None, h0=None, chunk: int = 64,
                   return_states: bool = False):
    """x (B, L, H, P); dt (B, L, H) positive; A (H,) negative; Bm/Cm
    (B, L, G, N) per state group (G divides H); D (H,) or None; h0
    (B, H, P, N) or None. Returns (y (B, L, H, P), h_final (B, H, P, N) f32)
    and, with ``return_states``, the chunk-start states (B, nc, H, P, N) f32
    at :func:`plan`'s chunk (None on the CPU), which the backward reads.

    CUDA tensors run the kernels (at :func:`plan`'s chunk); CPU tensors run
    the plain version at :func:`pick_chunk`'s."""
    global launches
    Bb, L, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    if all_on_cpu(x, dt, A, Bm, Cm, D, h0):
        y, h = ref.ssd(x, dt, A, Bm, Cm, D=D, h0=h0, chunk=pick_chunk(L, chunk))
        return (y, h, None) if return_states else (y, h)
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
    dev, dtype = check_cuda_tensors(args, "ssd", F32_ARGS)
    cs, nc = plan(L, chunk)
    y = torch.empty_like(x)
    h_final = torch.empty((Bb, H, P, N), dtype=torch.float32, device=x.device)
    # each chunk's start state, (B, nc, H, P, N): written by the first
    # launch, read by the second
    states = torch.empty((Bb, nc, H, P, N), dtype=torch.float32, device=x.device)
    vec4 = P % 4 == 0 and N % 4 == 0 and all(
        t.data_ptr() % 16 == 0 for t in (x, Bm, Cm, h0) if t is not None)
    with torch.cuda.device(dev):
        library(dtype == torch.bfloat16).launch(
            y.data_ptr(), h_final.data_ptr(), states.data_ptr(), x.data_ptr(), dt.data_ptr(),
            A.data_ptr(), Bm.data_ptr(), Cm.data_ptr(), None if D is None else D.data_ptr(),
            None if h0 is None else h0.data_ptr(), Bb, L, H, P, G, N, cs, nc, int(vec4),
            stream_of(dev))
    launches += 1
    return (y, h_final, states) if return_states else (y, h_final)


def bwd_heads_per_block(Bb: int, L: int, H: int, G: int, chunk: int) -> int:
    """Heads a chunk block of the backward takes (``csrc/ssd_bwd.cu``'s
    ``heads_per_block``): the whole group where the call has fewer blocks
    than the card has SMs, otherwise the most (a divisor of H / G) that keep
    at least four blocks an SM."""
    rep, blocks = H // G, plan(L, chunk)[1] * Bb * H
    if blocks < _SMS:
        return rep
    return max((d for d in range(1, rep + 1) if rep % d == 0 and blocks // d >= 4 * _SMS),
               default=1)


def bwd_smem_floats(N: int) -> int:
    """Shared memory of a chunk block of the backward in floats
    (``csrc/ssd_bwd.cu``'s ``chunk_smem``): x and dy (64 steps x 64 p), B and
    C (64 steps x N padded to 32), the chunk's Gin and start state (64 p x N
    padded to 32), dt and the log decay."""
    ldn = -(-N // 32) * 32
    return 2 * KERNEL_CHUNK * _TILE + 4 * KERNEL_CHUNK * ldn + 2 * KERNEL_CHUNK


def bwd_work_floats(Bb: int, L: int, H: int, P: int, G: int, N: int, chunk: int,
                    bf16: bool = False) -> int:
    """f32 scratch of the backward (``csrc/ssd_bwd.cu``'s ``work_floats``):
    the chunk-state gradients (B, nc, H, P, N), the slices' dB and dC where
    a group has more than one slice or the gradients are bf16 (summed in
    f32, rounded once by the fold), two values a step and head, two a
    (b, h); each part rounded up to 4 floats."""
    nc = plan(L, chunk)[1]
    ns = H // G // bwd_heads_per_block(Bb, L, H, G, chunk)

    def r4(n):
        return -(-n // 4) * 4

    return (r4(Bb * nc * H * P * N) + (2 * r4(Bb * L * G * ns * N) if ns > 1 or bf16 else 0)
            + 2 * r4(Bb * L * H) + 2 * r4(Bb * H))


def bwd_arguments(x, dt, A, Bm, Cm, dy, D, h0, dh_final, states, h_final, chunk: int):
    """The backward's gradients (a dict as ``ref.ssd_bwd`` returns it) and
    its entry point's arguments but the stream, for tensors on one device
    (the card, or the CPU for ``rehearse``)."""
    Bb, L, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    cs, nc = plan(L, chunk)
    grads = {"dx": torch.empty_like(x), "ddt": torch.empty_like(dt), "dA": torch.empty_like(A),
             "dB": torch.empty_like(Bm), "dC": torch.empty_like(Cm),
             "dD": None if D is None else torch.empty_like(D),
             "dh0": None if h0 is None else torch.empty_like(h0)}
    size = bwd_work_floats(Bb, L, H, P, G, N, chunk, x.dtype == torch.bfloat16)
    work = torch.empty((size,), dtype=torch.float32, device=x.device)

    def ptr(t):
        return None if t is None else t.data_ptr()

    args = (*(ptr(grads[k]) for k in ("dx", "ddt", "dA", "dB", "dC", "dD", "dh0")),
            work.data_ptr(), ptr(dy), ptr(dh_final), ptr(h_final), ptr(states), ptr(x),
            ptr(dt), ptr(A), ptr(Bm), ptr(Cm), ptr(D), Bb, L, H, P, G, N, cs, nc, size)
    return grads, args, work


def ssd_chunk_scan_bwd(x, dt, A, Bm, Cm, dy, D=None, h0=None, dh_final=None, states=None,
                       h_final=None, chunk: int = 64):
    """The gradients of :func:`ssd_chunk_scan` given ``dy`` (B, L, H, P) and,
    if not None, ``dh_final``: a dict with dx, ddt, dA, dB and dC (per state
    group, summed over its heads), dD and dh0 (None where D or h0 is), each
    in its input's dtype.

    CUDA tensors run ``csrc/ssd_bwd.cu`` from the forward's chunk-start
    ``states`` (and ``h_final`` where ``dh_final`` is given), at
    :func:`plan`'s chunk, the forward's own; CPU tensors run the plain
    version (``ref.ssd_bwd``) at :func:`pick_chunk`'s."""
    global launches_bwd
    Bb, L, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    if all_on_cpu(x, dt, A, Bm, Cm, dy, D, h0, dh_final):
        return ref.ssd_bwd(x, dt, A, Bm, Cm, dy, D=D, h0=h0, dh_final=dh_final,
                           chunk=pick_chunk(L, chunk))
    cs, nc = plan(L, chunk)
    args = {"x": (x, (Bb, L, H, P)), "dt": (dt, (Bb, L, H)), "A": (A, (H,)),
            "Bm": (Bm, (Bb, L, G, N)), "Cm": (Cm, (Bb, L, G, N)), "dy": (dy, (Bb, L, H, P)),
            "states": (states, (Bb, nc, H, P, N))}
    for name, t, shape in (("D", D, (H,)), ("h0", h0, (Bb, H, P, N)),
                           ("dh_final", dh_final, (Bb, H, P, N)),
                           ("h_final", h_final if dh_final is not None else None,
                            (Bb, H, P, N))):
        if t is not None:
            args[name] = (t, shape)
    if states is None or (dh_final is not None and h_final is None):
        raise ValueError("ssd_bwd: needs the forward's chunk-start states, and h_final "
                         "where dh_final is given")
    if G < 1 or H % G or not 1 <= N <= MAX_N_BWD or Bb * H > _MAX_GRID_Z:
        raise ValueError(f"ssd_bwd: needs G | H, 1 <= N <= {MAX_N_BWD} and B * H <= "
                         f"{_MAX_GRID_Z}, got G={G}, H={H}, N={N}, B={Bb}")
    dev, dtype = check_cuda_tensors(args, "ssd_bwd", F32_ARGS)
    grads, cargs, _work = bwd_arguments(x, dt, A, Bm, Cm, dy, D, h0, dh_final, states,
                                        h_final, chunk)
    with torch.cuda.device(dev):
        bwd_library(dtype == torch.bfloat16).launch(*cargs, stream_of(dev))
    launches_bwd += 1
    return grads


class SSDFn(torch.autograd.Function):
    """:func:`ssd_chunk_scan` with its backward on ``csrc/ssd_bwd.cu``: what
    ``ops.ssd`` runs on CUDA tensors that need a gradient. Returns (y,
    h_final)."""

    @staticmethod
    def forward(ctx, x, dt, A, Bm, Cm, D, h0, chunk):
        y, h_final, states = ssd_chunk_scan(x, dt, A, Bm, Cm, D=D, h0=h0, chunk=chunk,
                                            return_states=True)
        ctx.chunk = chunk
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x, dt, A, Bm, Cm, D, h0, states, h_final)
        return y, h_final

    @staticmethod
    def backward(ctx, dy, dh_final):
        x, dt, A, Bm, Cm, D, h0, states, h_final = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros_like(x)
        g = ssd_chunk_scan_bwd(x, dt, A, Bm, Cm, dy.contiguous(), D=D, h0=h0,
                               dh_final=None if dh_final is None else dh_final.contiguous(),
                               states=states, h_final=h_final, chunk=ctx.chunk)
        return g["dx"], g["ddt"], g["dA"], g["dB"], g["dC"], g["dD"], g["dh0"], None
