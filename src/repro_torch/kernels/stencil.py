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
the card's f32 operations per byte. The generated kernel loads each tap
from device memory through L1/L2 (one thread per column segment, threadIdx.x
along the contiguous z axis so loads coalesce); the reduction epilogue folds
the values already in registers, so a checked step moves no more bytes than
a plain one.

Staggered fields and boundary conditions live in the same launch: the
grid covers the base (cell-centred) extent, each face-centred field is
indexed with the strides of its own shape class, and a face cell of an
output with a boundary condition computes its value in place
(``kernels/codegen.py``). There is no second pass, and nothing falls back to
the ``torch`` backend: a build or launch failure raises.

On the CPU, a :class:`StencilCall` runs the same tap program with torch
operators (``codegen.evaluate_torch``), only because the tensors it was given
lie there.
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
from . import build, codegen

# Launches of the generated kernels, by kernel name; ``run`` adds one where it
# launches, and nowhere else.
launches: collections.Counter = collections.Counter()

# 2048 threads per SM on Hopper, 256 per block.
RESIDENT_BLOCKS_PER_SM = 2048 // (codegen.BLOCK_Z * codegen.BLOCK_Y)
# Blocks in flight per launch, in waves of the card's resident capacity.
WAVES = 4
_MAX_GRID_YZ = 65535


@dataclasses.dataclass(frozen=True)
class Launch:
    """Grid of one launch over a 3-D extent (lower-rank grids pad leading
    axes with 1): ``grid`` is (blocks along z, along y, x chunks), ``xc``
    the planes each thread marches."""

    grid: tuple[int, int, int]
    block: tuple[int, int, int]
    xc: int

    @property
    def n_blocks(self) -> int:
        return math.prod(self.grid)


def derive_launch(shape3: tuple[int, int, int], n_sm: int) -> Launch:
    """Blocks of 32 (z) x 8 (y) threads, each thread marching ``xc`` planes
    along x; ``xc`` is cut so that the launch holds about ``WAVES`` waves
    of the SMs' resident blocks."""
    nx, ny, nz = shape3
    gz, gy = -(-nz // codegen.BLOCK_Z), -(-ny // codegen.BLOCK_Y)
    target = WAVES * RESIDENT_BLOCKS_PER_SM * n_sm
    chunks = min(nx, max(1, -(-target // (gz * gy))))
    xc = -(-nx // chunks)
    gx = -(-nx // xc)
    if gy > _MAX_GRID_YZ or gx > _MAX_GRID_YZ:
        raise ValueError(f"grid {shape3} exceeds the CUDA grid limits")
    return Launch((gz, gy, gx), (codegen.BLOCK_Z, codegen.BLOCK_Y, 1), xc)


def check_cuda_fields(tensors: Mapping[str, torch.Tensor], shape) -> torch.device:
    """Every tensor on one CUDA device, float32, C-contiguous, of ``shape``
    (one shape for all, or a shape per name); raises on anything else
    (nothing is moved or copied silently)."""
    devices = {t.device for t in tensors.values()}
    if len(devices) != 1:
        raise ValueError(f"fields lie on several devices {sorted(map(str, devices))}")
    (dev,) = devices
    for n, t in tensors.items():
        if t.dtype != torch.float32:
            raise TypeError(f"field {n!r} is {t.dtype}; the CUDA kernel takes float32")
        want = tuple(shape[n] if isinstance(shape, Mapping) else shape)
        if tuple(t.shape) != want:
            raise ValueError(f"field {n!r} has shape {tuple(t.shape)}, expected {want}")
        if not t.is_contiguous():
            raise ValueError(f"field {n!r} is not contiguous")
    return dev


def stream_of(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


class StencilCall:
    """One generated kernel for a traced update (f32 fields, collocated or
    staggered) with its outputs' boundary conditions (``bcs``, normalized)."""

    def __init__(self, ir: StencilIR, label: str,
                 bcs: Mapping[str, BoundaryCondition] | None = None):
        unsupported(ir)
        self.ir = ir
        self.label = label
        self.program = codegen.lower(ir, bcs)
        self.classes = codegen.shape_classes(self.program)
        self.divisors = codegen.divisor_params(self.program)
        self.source = codegen.cuda_source(self.program)
        self.lib_name = "stencil_" + re.sub(r"[^A-Za-z0-9_]", "_", label)
        self.launch_info: dict[tuple, Launch] = {}
        self._lib: build.Library | None = None

    def _library(self) -> build.Library:
        if self._lib is None:
            p = self.program
            argtypes = [ctypes.c_void_p] * (len(p.fields) + len(p.outputs) + len(p.reductions))
            # scalar parameters, then the reciprocals of the divisors, as f32
            argtypes += [ctypes.c_float] * (len(p.params) + len(self.divisors))
            # base extents, two strides per shape class, xc, the grid
            argtypes += [ctypes.c_int64] * (3 + 2 * len(self.classes) + 4) + [ctypes.c_void_p]
            self._lib = build.Library(self.lib_name, self.source, argtypes)
        return self._lib

    def run(self, fields: Mapping[str, torch.Tensor], scalars: Mapping[str, Any]):
        """``(outs, reds)``: new output tensors, and the reductions as 0-d
        tensors (None without reductions).

        CPU tensors take the tap program's torch form, as every kernel
        wrapper of the port takes its plain version on the CPU. No engine
        path reaches that branch (``backend="cuda"`` refuses to start off
        the card); it serves a caller that holds a :class:`StencilCall`
        directly, such as the CPU tests of the launch wrapper."""
        p = self.program
        ins = {f: fields[f] for f in p.fields}
        if all(t.device.type == "cpu" for t in ins.values()):
            return codegen.evaluate_torch(p, ins, scalars)
        dev = check_cuda_fields(ins, self.ir.field_shapes)
        shape3 = codegen.pad3(self.ir.base_shape, 1)
        strides = []
        for off in self.classes:
            _, ny, nz = (n - d for n, d in zip(shape3, off))
            strides += [ny * nz, nz]
        launch = derive_launch(shape3, torch.cuda.get_device_properties(dev).multi_processor_count)
        self.launch_info[tuple(self.ir.base_shape)] = launch
        outs = {op.name: torch.empty_like(ins[op.name]) for op in p.outputs}
        parts = [torch.empty(launch.n_blocks, dtype=torch.float32, device=dev)
                 for _ in p.reductions]
        host = [float(v) for v in p.host_values(scalars)]
        host += [codegen.reciprocal(host[k]) for k in self.divisors]
        lib = self._library()
        with torch.cuda.device(dev):
            lib.launch(*(t.data_ptr() for t in ins.values()),
                       *(t.data_ptr() for t in outs.values()),
                       *(t.data_ptr() for t in parts), *host,
                       *shape3, *strides, launch.xc, *launch.grid, stream_of(dev))
        launches[self.label] += 1
        if not p.reductions:
            return outs, None
        return outs, {name: r.finish(part) for (name, r), part in zip(p.reductions, parts)}


def unsupported(ir: StencilIR) -> None:
    """Raise ``NotImplementedError`` for what the generated kernel does not
    take yet, naming the ROADMAP item that will port it."""
    if ir.ndim > 3:
        raise NotImplementedError("the generated CUDA kernel handles 1-3 dimensions")
