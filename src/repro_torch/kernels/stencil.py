"""The generated ``@parallel`` kernel: launch derivation and ``run``.

This is the counterpart of the generic Pallas launch
``src/repro/kernels/stencil.py::build_stencil_call``. ``kernels/codegen.py``
prints one ``__global__`` function for each (IR, dtype, reduction set);
:class:`StencilCall` builds it (cached by a hash of the source), checks its
arguments and launches it on PyTorch's current stream. It returns
``(outs, reds)`` with the reference's contract: outputs are new tensors,
holding the update on the written region and the previous value on the
ring; each reduction is a 0-d tensor finished from per-block partials.

What bounds it on the H100: bytes. The Fig. 1 step reads T and Ci and
writes T2 once (12 bytes per cell) for about 16 f32 operations, far below
the card's f32 operations per byte; the coupled solvers' fused updates do
45-48 operations per cell on 16-20 bytes. So the kernel must not multiply
its operations: ``codegen.lower`` gives one launch a single tap program
shared by its outputs, and stages each intermediate read at several shifts
(GP's ``re1``, porosity's face fluxes) once per cell in shared memory, as
the reference's window-wise body computes it once per window cell. A block
owns a tile of (y, z) columns, threadIdx.x along the contiguous z axis so
loads coalesce, and marches a chunk of x planes (a 2-D grid marches its
first axis), so the per-thread set-up and the 64-bit block base are paid
once per column and offsets inside the block are 32-bit. The fields' own
taps are loaded from device memory through L1/L2. Reductions accumulate in
registers over the march and fold once per block (warp shuffles, then
shared memory), so a checked step moves no more bytes than a plain one.

Staggered fields and boundary conditions live in the same launch: the
grid covers the base (cell-centred) extent, each face-centred field is
indexed with the strides of its own shape class, and a face cell of an
output with a boundary condition computes its value in place
(``kernels/codegen.py``). There is no second pass, and nothing falls back to
the ``torch`` backend: a build or launch failure raises.

A :class:`StencilCall` made with ``nsteps`` k > 1 launches the k-step kernel
of ``kernels/codegen_steps.py`` instead: k sweeps in one launch, each output
rotating into its target, the fields crossing device memory once (the
counterpart of ``build_stencil_call(nsteps=k)``).

Fields may be stored narrower than they are computed (``dtype`` bf16 or
f16, compute f32: :func:`default_compute_dtype`): the kernel widens each
load, computes in f32 and rounds each output to its storage type on store
(round to nearest even); reductions fold the stored values in f32
(:func:`accum_dtype`), so a bf16 step moves half the bytes of an f32 one.
At 2 bytes the single step of a program in ``codegen.PAIRS`` takes the pair
layout (``kernels/codegen_pairs.py``: 2 or 4 cells of the contiguous axis a
thread, moved as one word) where its fields' extents and strides allow,
decided when the :class:`StencilCall` is built, and each launch whose
fields' addresses are not aligned to its words takes the one-cell layout of
the same program instead (:meth:`StencilCall.layout_call`);
``launch_info`` names the layout each launch took.

A marched call (``march_axis=a``, the counterpart of the reference's
streamed launch, ``src/repro/kernels/stencil.py:826-833``) lays the
program out with axis ``a`` on the kernel's x (``codegen.march_layout``),
so each block walks its columns along ``a``: the planes a step reads stay
in L1 (and the stages' queues) for the next steps. Its chunks are cut as
the all-parallel launch's are (``WAVES``, ``STEPS_WAVES``): longer ones,
which refetch fewer lag and halo planes, measured slower on the H100 for
their last wave (``launch/tune_stencil.py --march``). A march along a
non-contiguous axis is a permutation of the kernel's x and y, its loads
still coalesced along z. A march along the contiguous axis puts a strided
axis on z; its kernels, single step and k steps, are async slabs
(``codegen.KernelShape.async_copies``): every field they read from device
memory is copied a step ahead into a plane queue in shared memory by
asynchronous copies, planes fastest, and their outputs go out from a step
buffer there a step later, planes fastest too, so warps move whole sectors
with every thread's copies of a step in flight at once; such a launch
takes its shared memory dynamically, up to 227 KB a block. The port's plane queue
(:attr:`StencilCall.queue_planes`) is the planes of the march axis one step
of a block touches: its planes, the taps' reach behind and ahead over its
sweeps, and the stages' lag (the k-step lead). A march extent shorter than
that launches the all-parallel kernel instead, and the call records
``march_fallback``.

On the CPU, a :class:`StencilCall` runs the same tap program with torch
operators (``codegen.evaluate_torch``, ``codegen.evaluate_steps_torch`` for
k sweeps), only because the tensors it was given lie there.
"""
from __future__ import annotations

import collections
import ctypes
import dataclasses
import math
import re
from typing import Any, Mapping

import torch

from ..ir.bc import BoundaryCondition
from ..ir.trace import StencilIR
from . import build, codegen, codegen_pairs, codegen_steps

# Launches of the generated kernels, by kernel name, and by (kernel name,
# grid shape); ``run`` adds one to each where it launches, and nowhere else.
launches: collections.Counter = collections.Counter()
shape_launches: collections.Counter = collections.Counter()

# Blocks per launch, in waves of the card's resident capacity: with more,
# shorter chunks the last wave idles less of the card, against the lag
# planes each chunk stages first (24 measured best on the H100, PERF.md).
WAVES = 24
# The same for the k-step kernels, whose chunks first compute a lead of
# planes that grows with k (8 measured best or within 3% of it on the H100,
# PERF.md).
STEPS_WAVES = 8
# The same for the slabs that march the contiguous axis, single step and k
# steps: a chunk first copies the planes behind its first step and waits for
# its first window, so chunks longer than WAVES cuts measured faster on the
# H100 (PERF.md).
SLAB_WAVES = 16
_MAX_GRID_YZ = 65535
_INT32_MAX = 2 ** 31 - 1


@dataclasses.dataclass(frozen=True)
class Launch:
    """Grid of one launch over a 3-D extent (``codegen.to3`` lays out lower
    ranks): ``grid`` is (blocks along z, along y, x chunks), ``xc`` the
    planes each block marches."""

    grid: tuple[int, int, int]
    block: tuple[int, int, int]
    xc: int
    layout: str = ""      # codegen.layout_name of the layout launched

    @property
    def n_blocks(self) -> int:
        return math.prod(self.grid)


def derive_launch(shape3: tuple[int, int, int], n_sm: int, kernel: codegen.KernelShape,
                  halo: int = 0, lag: int = 0, waves: int | None = None,
                  strides3: tuple[int, int, int] | None = None) -> Launch:
    """Blocks of the kernel's tile of (z, y) threads, each block marching a
    chunk of ``xc`` planes along x after staging ``lag`` planes ahead; the
    chunk and its lag fill whole steps of the kernel's planes (the last
    chunk ends at the grid's end). The chunk is cut so that the launch holds
    about ``waves`` (by default ``WAVES``) waves of the SMs' resident blocks,
    so the last wave idles the card for a small share of the run, and so
    that a chunk and ``halo`` planes on either side stay within 32-bit
    offsets (``strides3``: the strides of the kernel's (x, y, z), by default
    those of a C-contiguous (nx, ny, nz) grid)."""
    nx, ny, nz = shape3
    (bz, by), step = kernel.cells, kernel.planes
    gz, gy = -(-nz // bz), -(-ny // by)
    target = (waves or WAVES) * kernel.min_blocks * n_sm
    chunks = min(nx, max(1, -(-target // (gz * gy))))
    xc = -(-(-(-nx // chunks) + lag) // step) * step - lag
    if strides3 is None:
        plane = ny * nz
        max_xc = (_INT32_MAX // plane - 2 * halo + lag) // step * step - lag
    else:
        # a block's offsets along y and z, halo included, and its chunk's along x
        sx, sy, sz = strides3
        plane = (by + 2 * halo) * sy + (bz + 2 * halo) * sz
        max_xc = ((_INT32_MAX - plane) // max(sx, 1) - 2 * halo + lag) // step * step - lag
    if max_xc < 1:
        raise ValueError(f"grid {shape3}: a plane of {plane} cells exceeds 32-bit offsets")
    xc = min(xc, max_xc)
    gx = -(-nx // xc)
    if gy > _MAX_GRID_YZ or gx > _MAX_GRID_YZ:
        raise ValueError(f"grid {shape3} exceeds the CUDA grid limits")
    return Launch((gz, gy, gx), (bz, by, 1), xc)


# Storage dtypes the generated and hand kernels take, each computed in f32.
STORAGE_DTYPES = (torch.float32, torch.bfloat16, torch.float16)


def default_compute_dtype(dtype: torch.dtype) -> torch.dtype:
    """The compute dtype a storage dtype implies (the reference's
    ``kernels/stencil.py::default_compute_dtype``): sub-f32 floats widen to
    float32 (stored narrow, computed in f32: cast on load, round on store),
    any other dtype computes in its own precision."""
    if dtype.is_floating_point and torch.finfo(dtype).bits < 32:
        return torch.float32
    return dtype


def accum_dtype(compute_dtype: torch.dtype) -> torch.dtype:
    """The dtype reductions accumulate in: never narrower than f32 (a bf16
    running sum stops growing after about 256 increments, and a convergence
    check would lose its signal), f64 for f64 compute."""
    return torch.promote_types(torch.float32, compute_dtype)


def dtype_tag(dtype: torch.dtype) -> str:
    """A storage dtype's short name in kernel labels: ``bf16``, ``f16``,
    ``f32``."""
    return {torch.float32: "f32", torch.bfloat16: "bf16", torch.float16: "f16"}[dtype]


def check_cuda_fields(tensors: Mapping[str, torch.Tensor], shape,
                      dtype: torch.dtype = torch.float32) -> torch.device:
    """Every tensor on one CUDA device, of storage ``dtype``, C-contiguous,
    of ``shape`` (one shape for all, or a shape per name); raises on
    anything else (nothing is moved, widened or copied silently)."""
    devices = {t.device for t in tensors.values()}
    if len(devices) != 1:
        raise ValueError(f"fields lie on several devices {sorted(map(str, devices))}")
    (dev,) = devices
    for n, t in tensors.items():
        if t.dtype != dtype:
            raise TypeError(f"field {n!r} is {t.dtype}; this CUDA kernel takes {dtype}")
        want = tuple(shape[n] if isinstance(shape, Mapping) else shape)
        if tuple(t.shape) != want:
            raise ValueError(f"field {n!r} has shape {tuple(t.shape)}, expected {want}")
        if not t.is_contiguous():
            raise ValueError(f"field {n!r} is not contiguous")
    return dev


def stream_of(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def check_march(ir: StencilIR, march_axis: int | None) -> None:
    """``ValueError`` for a field staggered along the march axis (the
    reference's rule: streaming slides collocated planes)."""
    if march_axis is None:
        return
    if not 0 <= march_axis < ir.ndim:
        raise ValueError(f"march_axis {march_axis} out of range for a {ir.ndim}-d stencil")
    for n, off in ir.offsets.items():
        if off[march_axis]:
            raise ValueError(
                f"march_axis {march_axis} points at a staggered axis: field {n!r} has "
                f"offset {off[march_axis]} there; streaming slides collocated planes, so "
                "stagger a non-marching axis or drop march_axis")


class StencilCall:
    """One generated kernel for a traced update (fields of storage
    ``dtype``, computed in f32, collocated or staggered) with its outputs'
    boundary conditions (``bcs``, normalized), laid out as ``shape`` (by
    default ``codegen.kernel_shape``) and marching ``march_axis`` (module
    docstring; its launches count under ``"{label}@m{axis}"``, and a march
    extent shorter than :attr:`queue_planes` falls back to the all-parallel
    kernel, ``march_fallback``). A sub-f32 kernel's launches count
    under ``"{label}:{bf16|f16}"``. With
    ``rotations`` the kernel is the k-step one (``codegen_steps``): it
    sweeps the update ``nsteps`` times in one launch, each output rotating
    into its ``rotations`` target, and its launches count under
    ``"{label}/k{nsteps}"`` (at ``nsteps`` 1 it is the k-step printer's
    single sweep, which ``launch/tune_stencil.py`` times against the
    single-step kernel)."""

    def __init__(self, ir: StencilIR, label: str,
                 bcs: Mapping[str, BoundaryCondition] | None = None,
                 shape: codegen.KernelShape | None = None, nsteps: int = 1,
                 rotations: Mapping[str, str] | None = None,
                 dtype: torch.dtype = torch.float32, march_axis: int | None = None):
        unsupported(ir)
        check_march(ir, march_axis)
        if dtype not in STORAGE_DTYPES:
            raise NotImplementedError(
                f"{label}: storage dtype {dtype} is not ported to the CUDA kernel "
                "(ROADMAP queue 1, item 3: f64 storage)")
        self.ir = ir
        self.dtype = dtype
        self._made = (label, bcs)
        self._cells: StencilCall | None = None
        self.nsteps = int(nsteps)
        if rotations is None and self.nsteps != 1:
            raise ValueError(f"{label}: {self.nsteps} sweeps per launch need rotations")
        if dtype != torch.float32:
            label = f"{label}:{dtype_tag(dtype)}"
        self.rotations = None if rotations is None else dict(rotations)
        self._lay_out(ir, bcs, shape, march_axis, label)
        self.march_fallback = False
        if march_axis is not None and ir.base_shape[march_axis] < self.queue_planes:
            # too short to fill the queue: the all-parallel kernel, as the
            # reference falls back
            self._lay_out(ir, bcs, shape, None, label)
            self.march_fallback = True
        if self.march_axis is not None:
            label = f"{label}@m{self.march_axis}"
        self.label = label if rotations is None else f"{label}/k{self.nsteps}"
        self.lib_name = "stencil_" + re.sub(r"[^A-Za-z0-9_]", "_", self.label)
        self.launch_info: dict[tuple, Launch] = {}
        self._lib: build.Library | None = None

    def _lay_out(self, ir: StencilIR, bcs, shape, march_axis: int | None, label: str) -> None:
        """The program, layout, source and march geometry for one march
        axis (None: the all-parallel layout)."""
        self.march_axis = march_axis
        self.program = codegen.lower(ir, bcs, march_axis)
        self.classes = codegen.shape_classes(self.program)
        self.divisors = codegen.divisor_params(self.program)
        dtype, rotations = self.dtype, self.rotations
        if rotations is None:
            self.shape = shape or codegen.kernel_shape(self.program, dtype)
            if self.shape.vec > 1 and not codegen_pairs.fits(
                    self.program, self.shape.vec, [self.extents3(o) for o in self.classes],
                    [self.strides3(o) for o in self.classes]):
                if shape is not None:
                    raise ValueError(f"{label}: the pair layout {codegen.layout_name(shape)} "
                                     f"does not fit the extents {tuple(ir.base_shape)}")
                # an extent the pairs do not divide: the one-cell layout
                self.shape = codegen.kernel_shape(self.program)
            smem = codegen.shared_bytes(self.program, self.shape)
            limit = codegen.SM_SHARED if self.shape.async_copies else codegen.SHARED_LIMIT
            if smem > limit:
                # the counterpart of the reference's preflight_vmem
                raise NotImplementedError(
                    f"{label}: its staged intermediates need {smem} bytes of shared memory "
                    f"per block, above the {limit} a block can have")
            self.source = codegen.cuda_source(self.program, self.shape, dtype)
            self.lag = codegen.march_lag(self.program, self.shape)
            # planes a chunk reads beyond its own: the taps' reach and the stages' lag
            self.halo = ir.inferred_radius + self.lag + self.shape.planes
        else:
            self.rotations = dict(rotations)
            self.shape = shape or codegen_steps.steps_shape(self.program, self.rotations,
                                                            self.nsteps, dtype=dtype)
            self.plan = codegen_steps.plan(self.program, self.rotations, self.nsteps,
                                           self.shape)
            self.source = codegen_steps.cuda_source(self.program, self.rotations,
                                                    self.nsteps, self.shape, dtype)
            self.lag = self.plan.lead
            self.halo = self.plan.reach
        # the plane queue: a step's planes, the taps' reach behind them over
        # the sweeps, and how far ahead it computes (the stages' lag and the
        # taps' reach ahead; the k-step lead holds both)
        self.queue_planes = 0
        if march_axis is not None:
            lo, hi = ir.halo[march_axis]
            ahead = self.lag + (hi if rotations is None else 0)
            self.queue_planes = self.shape.planes + self.nsteps * lo + ahead

    def argtypes(self) -> list:
        """The ``ctypes`` types of the entry point's arguments."""
        p = self.program
        argtypes = [ctypes.c_void_p] * (len(p.fields) + len(p.outputs) + len(p.reductions))
        # scalar parameters, then the reciprocals of the divisors, as f32
        argtypes += [ctypes.c_float] * (len(p.params) + len(self.divisors))
        # base extents, two strides per shape class (three where z is
        # strided), xc, the grid
        n_strides = len(codegen.stride_names(p))
        return argtypes + [ctypes.c_int64] * (3 + n_strides + 4) + [ctypes.c_void_p]

    def _library(self) -> build.Library:
        if self._lib is None:
            self._lib = build.Library(self.lib_name, self.source, self.argtypes())
        return self._lib

    def run(self, fields: Mapping[str, torch.Tensor], scalars: Mapping[str, Any]):
        """``(outs, reds)``: new output tensors, and the reductions as 0-d
        tensors (None without reductions).

        CPU tensors take the tap program's torch form, as every kernel
        wrapper of the port takes its plain version on the CPU (at the
        fields' own storage dtype, computed in f32). No engine
        path reaches that branch (``backend="cuda"`` refuses to start off
        the card); it serves a caller that holds a :class:`StencilCall`
        directly, such as the CPU tests of the launch wrapper."""
        p = self.program
        ins = {f: fields[f] for f in p.fields}
        if all(t.device.type == "cpu" for t in ins.values()):
            if self.rotations is None:
                return codegen.evaluate_torch(p, ins, scalars)
            return codegen.evaluate_steps_torch(p, self.rotations, self.nsteps, ins, scalars)
        dev = check_cuda_fields(ins, self.ir.field_shapes, self.dtype)
        call, outs, parts, args = self.prepare(
            ins, scalars, torch.cuda.get_device_properties(dev).multi_processor_count)
        with torch.cuda.device(dev):
            call._library().launch(*args, stream_of(dev))
        launches[self.label] += 1
        shape_launches[self.label, tuple(self.ir.base_shape)] += 1
        return self.finish(outs, parts)

    def layout_call(self, ins: Mapping[str, torch.Tensor]) -> "StencilCall":
        """The call that launches on ``ins``: this one, or, for the pair
        layout on fields whose addresses are not aligned to its words (a
        view at an odd offset), the one-cell layout of the same program
        (``codegen.kernel_shape``), counted under this call's label."""
        vec = self.shape.vec
        if vec == 1 or codegen_pairs.aligned_ptrs((t.data_ptr() for t in ins.values()), vec,
                                                  self.dtype.itemsize):
            return self
        if self._cells is None:
            label, bcs = self._made
            self._cells = StencilCall(self.ir, label, bcs, codegen.kernel_shape(self.program),
                                      dtype=self.dtype)
        return self._cells

    def prepare(self, ins: Mapping[str, torch.Tensor], scalars: Mapping[str, Any], n_sm: int,
                xc: int | None = None, divisor=codegen.reciprocal):
        """``(call, outs, parts, args)`` of one launch on ``ins``: the call
        that launches (:meth:`layout_call`) and its :meth:`arguments`; the
        launch is recorded in ``launch_info`` with the layout it takes."""
        call = self.layout_call(ins)
        launch, outs, parts, args = call.arguments(ins, scalars, n_sm, xc, divisor)
        self.launch_info[tuple(self.ir.base_shape)] = dataclasses.replace(
            launch, layout=codegen.layout_name(call.shape))
        return call, outs, parts, args

    def arguments(self, ins: Mapping[str, torch.Tensor], scalars: Mapping[str, Any],
                  n_sm: int, xc: int | None = None, divisor=codegen.reciprocal):
        """``(launch, outs, parts, args)`` of one launch on ``ins`` for a
        card of ``n_sm`` SMs (or with chunks of ``xc`` planes): new outputs
        and per-block partials beside ``ins``, and the entry point's
        arguments but the stream; ``divisor`` of each scalar divisor is
        passed after the parameters."""
        p = self.program
        shape3 = p.to3(self.ir.base_shape, 1)
        strides = [s for off in self.classes
                   for s in self.strides3(off)[:3 if p.z_strided else 2]]
        launch = self.derive(n_sm, xc)
        dev = next(iter(ins.values())).device
        outs = {op.name: torch.empty_like(ins[op.name]) for op in p.outputs}
        # partials at the accumulation dtype (f32), whatever the storage
        parts = [torch.empty(launch.n_blocks, dtype=torch.float32, device=dev)
                 for _ in p.reductions]
        host = [float(v) for v in p.host_values(scalars)]
        host += [divisor(host[k]) for k in self.divisors]
        args = [*(t.data_ptr() for t in ins.values()), *(t.data_ptr() for t in outs.values()),
                *(t.data_ptr() for t in parts), *host, *shape3, *strides, launch.xc,
                *launch.grid]
        return launch, outs, parts, args

    def extents3(self, off3=(0, 0, 0)) -> tuple[int, int, int]:
        """The extents along the kernel's (x, y, z) of a field of the shape
        class ``off3``."""
        return tuple(n - d for n, d in zip(self.program.to3(self.ir.base_shape, 1), off3))

    def strides3(self, off3=(0, 0, 0)) -> tuple[int, int, int]:
        """The strides along the kernel's (x, y, z) of a field of the shape
        class ``off3``: those of its program axes as laid out, and for a
        kernel axis no program axis lies on (extent 1) the product of the
        extents after it."""
        p = self.program
        ext3 = [n - d for n, d in zip(p.to3(self.ir.base_shape, 1), off3)]
        ext = [ext3[k] for k in p.axes3]                  # the field's own extents
        own = [math.prod(ext[a + 1:]) for a in range(len(ext))]
        out = [math.prod(ext3[k + 1:]) for k in range(3)]
        for a, k in enumerate(p.axes3):
            out[k] = own[a]
        return tuple(out)

    def derive(self, n_sm: int, xc: int | None = None) -> Launch:
        """The launch on a card of ``n_sm`` SMs (or with chunks of ``xc``
        planes): ``WAVES`` waves of blocks (``STEPS_WAVES`` for k steps,
        ``SLAB_WAVES`` for an async slab)."""
        shape3 = self.program.to3(self.ir.base_shape, 1)
        waves = waves_of(self.shape, self.rotations is not None)
        launch = derive_launch(shape3, n_sm, self.shape, self.halo, self.lag, waves,
                               self.strides3() if self.program.layout else None)
        if xc is not None:
            launch = Launch((*launch.grid[:2], -(-shape3[0] // xc)), launch.block, xc)
        return launch

    def cost_tile(self, n_sm: int = 132) -> tuple[int, ...]:
        """The block extent of this call's launch per field axis (a chunk
        along the marched axis): the tile of the cost model's
        ``fetched_bytes_per_step`` and ``a_eff_streamed``."""
        launch = self.derive(n_sm)
        ext3 = (launch.xc, self.shape.cells[1], self.shape.cells[0])
        return tuple(ext3[k] for k in self.program.axes3)

    def finish(self, outs, parts):
        """``(outs, reds)`` with each reduction finished from its partials."""
        if not self.program.reductions:
            return outs, None
        return outs, {name: r.finish(part)
                      for (name, r), part in zip(self.program.reductions, parts)}


def waves_attr(shape: codegen.KernelShape, steps: bool) -> str:
    """The name of the module constant that sets a layout's waves."""
    return "SLAB_WAVES" if shape.async_copies else "STEPS_WAVES" if steps else "WAVES"


def waves_of(shape: codegen.KernelShape, steps: bool) -> int:
    return globals()[waves_attr(shape, steps)]


def unsupported(ir: StencilIR) -> None:
    """Raise ``NotImplementedError`` for what the generated kernel does not
    take yet, naming the ROADMAP item that will port it."""
    if ir.ndim > 3:
        raise NotImplementedError("the generated CUDA kernel handles 1-3 dimensions")
