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
(:func:`ref.stored_scalars`) and every operation rounds to it. A bf16 or
f16 single step takes the pair layout (two cells of z a thread) where
:func:`pairs_fit` holds, else one cell a thread; k steps run over tiles of
:func:`tile_rows` rows. The source makes the same choices from the same
arguments, and this module sizes the grid by them; ``last_layout`` names
the one the last launch took.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import build, ref
from .codegen import KernelShape
from .stencil import STORAGE_DTYPES, Launch, check_cuda_fields, derive_launch, stream_of

SOURCE = build.CSRC_DIR / "diffusion3d.cu"

# Launches of the CUDA kernel; :func:`diffusion3d_step` adds one where it
# launches, and nowhere else. ``last_layout`` names the layout of its last
# launch (:func:`layout`).
launches = 0
last_layout = None

_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_float] * 5 + [ctypes.c_int64] * 9
             + [ctypes.c_void_p])
_BLOCK = (32, 8)            # threads along (z, y) of the single step, as in the source
PAIR_WAVES = 8              # waves of the 2-byte single step's pair layout
STEPS_WAVES = 3             # waves of the k-step kernel's resident blocks
# The k-step kernel's tile (32 cells of z; its rows, :func:`tile_rows`),
# planes per step and threads, as in the source (kTile, kP, kStepThreads);
# its rings and queues (kRing, kSlots).
_TILE_Z, _PLANES, _STEP_THREADS = 32, 2, 256
_RING, _SLOTS = 6, 4
MAX_STEPS = 4               # the largest nsteps a launch takes (kMaxSteps)
MAX_RESIDENT = 2            # the k-step kernel's most resident blocks (kMaxResident)


def chunks(nsteps: int) -> list[int]:
    """The steps of each launch that :func:`diffusion3d_step` makes for
    ``nsteps``: MAX_STEPS each, then the rest."""
    return [MAX_STEPS] * (nsteps // MAX_STEPS) + [nsteps % MAX_STEPS] * (nsteps % MAX_STEPS > 0)


def tile_rows(nsteps: int, itemsize: int = 4) -> int:
    """The k-step kernel's tile rows along y (the source's ``tile_rows``,
    tuned on the H100): f32 32 / 24 / 16 at k = 2 / 3 / 4, 2 bytes 32 / 32
    / 24."""
    if itemsize == 4:
        return {2: 32, 3: 24}.get(nsteps, 16)
    return 24 if nsteps == 4 else 32


def stage_ci(nsteps: int, itemsize: int = 4) -> bool:
    """Whether the k-step kernel stages Ci through a ring of its own (the
    source's ``stage_ci``; the other choice, each sweep reading Ci from
    device memory, is timed by ``tune_stencil --hand``): always."""
    return nsteps > 0 and itemsize > 0


def shared_bytes(nsteps: int, itemsize: int = 4, ci: bool | None = None,
                 rows: int | None = None) -> int:
    """Shared memory of one block of the k-step kernel (the source's
    ``shared_cells``; ``ci`` overrides :func:`stage_ci`, ``rows``
    :func:`tile_rows`): over 32 x ``rows`` tiles, T's ring of 6 planes with
    ``k`` cells of halo per side, Ci's ring of ``k + 3`` planes with ``k -
    1`` cells where it is staged, and a queue of 4 planes with ``h`` cells
    for each sweep but the last (``h`` from ``k - 1`` down to 1); 0 for one
    step."""
    if nsteps == 1:
        return 0
    ci = stage_ci(nsteps, itemsize) if ci is None else ci
    rows = tile_rows(nsteps, itemsize) if rows is None else rows

    def area(h):
        return (_TILE_Z + 2 * h) * (rows + 2 * h)

    cells = (_RING * area(nsteps) + (nsteps + 1 + _PLANES) * area(nsteps - 1) * ci
             + _SLOTS * sum(area(h) for h in range(1, nsteps)))
    return itemsize * cells


def resident(nsteps: int, itemsize: int = 4, ci: bool | None = None,
             cap: int = MAX_RESIDENT, rows: int | None = None) -> int:
    """Blocks of the k-step kernel an SM holds: what its shared memory leaves
    room for, at most ``cap`` (the source's ``resident`` and
    ``kMaxResident``, its launch bounds)."""
    return min(cap, 232448 // shared_bytes(nsteps, itemsize, ci, rows))


def pairs_fit(nz: int, *fields: torch.Tensor) -> bool:
    """Whether a 2-byte single step takes the pair layout (the source's
    ``pairs_fit``): two cells of z a thread need nz even and every field
    4-byte aligned. float32 fields never do."""
    return (all(t.element_size() == 2 for t in fields) and nz % 2 == 0
            and all(t.data_ptr() % 4 == 0 for t in fields))


def layout(nsteps: int, itemsize: int = 4, pairs: bool = False) -> str:
    """The launch's layout by name: the single step's ``cells`` (32 x 8
    threads, one cell a thread) or ``pairs`` (two cells of z a thread), or
    the k-step kernel's tile, threads, resident blocks and where Ci comes
    from (``ci-ring`` staged, ``ci-ldg`` read by each sweep)."""
    if nsteps == 1:
        return "pairs" if pairs else "cells"
    ci = "ci-ring" if stage_ci(nsteps, itemsize) else "ci-ldg"
    return (f"{_TILE_Z}x{tile_rows(nsteps, itemsize)}/p{_PLANES}/t{_STEP_THREADS}"
            f"/b{resident(nsteps, itemsize)}/{ci}")


def column_launch(shape: tuple[int, int, int], n_sm: int, nsteps: int = 1,
                  itemsize: int = 4, pairs: bool = False, waves: int | None = None,
                  ci: bool | None = None, cap: int = MAX_RESIDENT,
                  rows: int | None = None) -> Launch:
    """One step: blocks of 32 (z) x 8 (y) threads, each thread marching ``xc``
    planes along x, in about 4 waves of the SMs' 8 resident blocks; with
    ``pairs`` two cells of z a thread, in ``PAIR_WAVES``. k steps: blocks of
    256 threads over a 32 x ``rows`` tile (:func:`tile_rows`) marching two
    planes per step, in about
    ``STEPS_WAVES`` waves of the blocks that reside (:func:`resident`),
    each chunk first computing ``2 k`` planes ahead of its own. ``waves``,
    ``ci``, ``cap`` and ``rows`` override the defaults (a variant of the
    source, tuning)."""
    if nsteps == 1:
        kernel = KernelShape(_BLOCK, 1, 8, vec=2 if pairs else 1)
        return derive_launch(shape, n_sm, kernel, waves=waves or (PAIR_WAVES if pairs else 4))
    rows = tile_rows(nsteps, itemsize) if rows is None else rows
    kernel = KernelShape((_TILE_Z, rows), _PLANES, resident(nsteps, itemsize, ci, cap, rows),
                         block=_STEP_THREADS)
    return derive_launch(shape, n_sm, kernel, lag=2 * nsteps, waves=waves or STEPS_WAVES)


@functools.cache
def library() -> build.Library:
    return build.Library("diffusion3d", build.read_source(SOURCE), _ARGTYPES)


def launch_on(lib: build.Library, launch: Launch, out, T2, T, Ci, scalars, nsteps: int) -> None:
    """One launch of ``lib`` (this source, or a variant of it built under
    another name) over ``launch``'s grid on the fields' card and its current
    stream; ``scalars`` are lam, dt and the inverse spacings."""
    dev = T.device
    with torch.cuda.device(dev):
        lib.launch(out.data_ptr(), T2.data_ptr(), T.data_ptr(), Ci.data_ptr(),
                   *ref.stored_scalars(T.dtype, *scalars), *T.shape, launch.xc, nsteps,
                   STORAGE_DTYPES.index(T.dtype), *launch.grid, stream_of(dev))


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

    CUDA tensors run the kernel; CPU tensors run the plain version. Above
    ``MAX_STEPS`` the steps run as launches of at most MAX_STEPS
    (:func:`chunks`), each into a new tensor with T's ring kept (its T2 the
    field it steps), the last with T2's ring into the result, as the
    reference's one launch keeps T's ring until its last step; on CPU tensors
    each is the plain k-step version. The scalars are squared here in Python
    double, as the plain version squares them, then rounded to the fields'
    dtype (``ref.stored_scalars``), and reach the kernel as f32."""
    global launches, last_layout
    nsteps = int(nsteps)
    if nsteps < 1:
        raise ValueError(f"nsteps must be >= 1, got {nsteps}")
    fields = {"T2": T2, "T": T, "Ci": Ci}
    on_cpu = all(t.device.type == "cpu" for t in fields.values())
    alias = (not on_cpu) if alias is None else bool(alias)
    if alias and (_shares_storage(T2, T) or _shares_storage(T2, Ci)):
        raise ValueError("alias=True writes into T2's buffer, which must not share "
                         "storage with T or Ci")
    if nsteps > MAX_STEPS:
        *ahead, last = chunks(nsteps)
        for k in ahead:
            T = diffusion3d_step(T, T, Ci, lam, dt, inv_dx, inv_dy, inv_dz, k, alias=False)
        return diffusion3d_step(T2, T, Ci, lam, dt, inv_dx, inv_dy, inv_dz, last, alias=alias)
    if on_cpu:
        out = ref.diffusion3d_steps(T2, T, Ci, lam, dt, inv_dx, inv_dy, inv_dz, nsteps)
        return T2.copy_(out) if alias else out
    if T.dim() != 3 or min(T.shape) < 3:
        raise ValueError(f"T must be 3-D with every extent >= 3, got {tuple(T.shape)}")
    if T.dtype not in STORAGE_DTYPES:
        raise TypeError(f"T is {T.dtype}; the CUDA kernel takes float32, bfloat16 or float16")
    dev = check_cuda_fields(fields, T.shape, T.dtype)
    out = T2 if alias else torch.empty_like(T)
    pairs = nsteps == 1 and pairs_fit(T.shape[2], out, T2, T, Ci)
    launch = column_launch(tuple(T.shape), torch.cuda.get_device_properties(dev)
                           .multi_processor_count, nsteps, T.element_size(), pairs)
    launch_on(library(), launch, out, T2, T, Ci, (lam, dt, inv_dx, inv_dy, inv_dz), nsteps)
    launches += 1
    last_layout = layout(nsteps, T.element_size(), pairs)
    return out
