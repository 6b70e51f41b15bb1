"""Print the k-step generated kernel: ``k`` sweeps of a tap program in one
launch, the counterpart of ``build_stencil_call(nsteps=k, rotations=...)``
(``src/repro/kernels/stencil.py:936-990``).

Each sweep runs the whole tap program of :mod:`.codegen` (core, stages,
the outputs' direct programs for rings, faces and staggered extents, and
``dirichlet``/``neumann0`` faces), and its outputs become the loads of
their rotation targets in the next sweep. The semantics are the
reference's: on an intermediate sweep a cell outside an output's write
region carries its rotation target's previous value (then the boundary
condition applies); the last sweep blends with the output's own previous
values; reductions fold over the last sweep only. The result equals ``k``
rotated single steps whenever each output and its target agree on the
write ring, as they do in the solvers.

Layout. A block owns the single-step kernel's tile of (y, z) columns and
marches a chunk of x planes. The launch is cut into **phases**, in order:
for each sweep, its stages, then its outputs. A phase computes, at each
step of the march, ``planes`` planes lying ``lag`` planes ahead of the
planes the last phase writes, over the tile widened by ``ext`` cells (its
consumers' reach, so the halo cone shrinks sweep by sweep), and keeps them
in a rolling queue of ``slots`` planes in shared memory; the last phase
writes device memory. Sweep 0 loads its fields from device memory, every
later sweep loads its rotation targets from the previous sweep's queues,
and fields that do not rotate (``Ci``, ``V``) are read from device memory
by every sweep. So the rotated fields cross device memory once per launch.
A ``neumann0`` face evaluates its output at its source cell, as in the
single-step kernel: the lag and the low side of the halo grow by the face
depth, so the source's taps lie inside the previous sweep's queue.

The all-parallel layout (:func:`_parallel_source`; the layout of a
program that is not marched) was redesigned for the H100, as its time per
step had grown with k (PERF.md, section 6). A block of ``shape.block``
threads owns a tile of ``shape.tile`` cells (32 x 16 for GP's fused update,
whose cone at radius 2 made a 32 x 8 tile compute 52% more than two sweeps
at k = 2; 32 x 32 for FIG1's step; 224 x 1 for porosity, whose widest
region then fits one round of 256 threads), and each phase's region is
walked in rounds of whole warps, a thread's cells fixed for the march
(:func:`rounds`): which rounds lie in the core (a stage's frame) is found
once, before the march, and each round's frame index and device offset
once a step. Every queue keeps its planes at one pitch, the frame's
(:class:`Frame`), so a tap of any queue is the cell's frame index plus a
constant, its ring slot a base advanced once a step; a field's taps are
read through a pointer to their row, so a tap along z is an immediate. The
fast cells of a step load unconditionally (a cell off the core loads at a
cell in it, ``s``, a step of planes or more from the core's end along x, so
that no load of the step leaves the fields), compute into registers and
store after, so every round's loads are in flight together; the others go
one by one through the core or their outputs' direct programs. A sweep's
stages share one barrier (no stage reads another), a barrier ends each
sweep's outputs, and a queue holds its readers' planes and one step more
only where no barrier stands between its last reader and its writer of the
next step (:func:`plan`).
A marched layout keeps the design before (every phase walked cell by cell,
each thread taking every ``threads``-th cell, a barrier after each phase,
every queue a step of planes deeper).

Marching the contiguous axis (``z_strided``), a warp's loads and stores of
device memory would be strided, so the launch is a slab, as the single-step
one is (``codegen.KernelShape.async_copies``, printed by the same emitters):
every field a phase reads from device memory (sweep 0's, and the fields
that do not rotate at every sweep) comes through a field queue that
asynchronous copies fill a step ahead, planes fastest, over the union of
the phases' regions and taps (:func:`field_boxes`); the last phase writes
its step of planes into a step buffer in shared memory, which goes out
planes fastest during the next step. The chunk's lead is rounded up to
whole 32-byte sectors of f32 (``codegen.ALIGN``).

Fields stored as bf16 or f16 are widened on load and computed in f32, as in
the single-step kernel. Each sweep's outputs are rounded to storage before
they enter their queue (the reference's k-step launch rounds each
intermediate sweep through storage), so ``run_steps(k)`` equals k single
steps, each of which stores its outputs, bitwise. The output queues hold
the storage type (half the shared memory of f32 queues; the layout is the
f32 twin's, see :func:`steps_shape`); a stage's queue holds f32, an
intermediate of the update and not a stored field.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Mapping

import torch

from .codegen import (KernelShape, LayoutRefused, Storage, TapProgram, _combine, _emit_copies,
                      _emit_copy_setup, _emit_core_box, _emit_direct, _emit_ops, _emit_step_store,
                      _emit_strides, _offset, _printer, _zs, aligned, base_tile, block_origin,
                      copy_helpers, divisor_params, emit_value, fold_line, grid_dims, out_row,
                      plane_words, ring_helper, ring_planes, shape_classes, slab_queues, storage,
                      stride_names)

# Shared memory a block can use on the H100 (232,448 bytes), above 48 KB
# only as dynamic shared memory after cudaFuncSetAttribute.
SHARED_LIMIT = 227 * 1024
# Layouts ((z, y) tile, planes per step) of a k-step kernel marching the
# contiguous axis, in order of preference by rank: the first whose queues
# fit; measured best on the H100 at k = 2 for FIG1, porosity and GP
# (PERF.md, section 6).
SLABS = {3: [((16, 8), 8), ((32, 4), 8), ((16, 4), 8), ((16, 4), 4)],
         2: [((64, 1), 8), ((128, 1), 8), ((64, 1), 4)]}

Box = tuple[tuple[int, int], tuple[int, int], tuple[int, int]]   # (lo, hi) per x, y, z


@dataclasses.dataclass(frozen=True)
class Phase:
    """One phase of the k-step launch: the stage ``stage`` of sweep
    ``sweep``, or its outputs (``stage`` None). ``ext`` widens the tile by
    (y lo, y hi, z lo, z hi) cells; ``lag`` is how far ahead of the
    written planes it computes; ``slots`` the planes of its queue (0 for
    the last phase, which writes device memory)."""

    sweep: int
    stage: int | None
    ext: tuple[int, int, int, int]
    lag: int
    slots: int
    barrier: bool = True       # a barrier ends it (the all-parallel layout)

    @property
    def name(self) -> str:
        return f"s{self.sweep}" + ("o" if self.stage is None else f"t{self.stage}")


@dataclasses.dataclass(frozen=True)
class Plan:
    """The phases of a k-step launch and the planes ``lead`` that a chunk
    computes before the first plane it writes."""

    nsteps: int
    rotations: tuple[tuple[str, str], ...]     # (output, target), in output order
    phases: tuple[Phase, ...]
    lead: int
    reach: int                                 # planes any phase reads beyond its own

    def region(self, ph: Phase, shape: KernelShape) -> tuple[int, int]:
        """Rows and columns (y, z) of one plane of the phase."""
        (bz, by), (ylo, yhi, zlo, zhi) = shape.tile, ph.ext
        return by + ylo + yhi, bz + zlo + zhi


def _box(offsets) -> Box:
    """Per axis of (x, y, z): how far below and above the cell the
    offsets (on the kernel's axes) reach (0 at least)."""
    offs = [tuple(o) for o in offsets] or [(0, 0, 0)]
    return tuple((max(0, -min(o[a] for o in offs)), max(0, max(o[a] for o in offs)))
                 for a in range(3))


def _add(a: Box, b: Box) -> Box:
    return tuple((x0 + y0, x1 + y1) for (x0, x1), (y0, y1) in zip(a, b))


def _max(a: Box, b: Box) -> Box:
    return tuple((max(x0, y0), max(x1, y1)) for (x0, x1), (y0, y1) in zip(a, b))


def plan(program: TapProgram, rotations: Mapping[str, str], nsteps: int,
         shape: KernelShape) -> Plan:
    """The phases of a ``nsteps``-sweep launch of ``program`` whose outputs
    rotate into their ``rotations`` targets, laid out as ``shape``: each
    phase's halo, lag and queue depth (``slots``), and whether a barrier
    ends it. In the all-parallel layout a sweep's stages share a barrier
    and a queue holds one step of planes beyond its readers' reach only
    where no barrier separates its last reader from its next write (FIG1's
    first sweep at k = 2); a marched layout keeps a barrier after every
    phase and that step in every queue."""
    k, P = int(nsteps), shape.planes
    if any(op.bc is not None and op.bc.kind == "periodic" for op in program.outputs):
        raise ValueError(
            "periodic boundary conditions cannot run inside a k-step launch (their "
            "wrap sources lie outside every block's window); run_steps realizes them "
            "as k single-step launches")
    targets = set(rotations.values())
    nd = program.ndim
    axes3 = program.axes3
    to3 = program.to3
    # the outputs' reach into the previous sweep: every tap of a target
    out_taps = [to3(off, 0) for op in program.outputs for f, off in op.loads if f in targets]
    out_taps += [to3(off, 0) for f, off in program.core.loads if f in targets]
    reach = _box(out_taps)
    # a neumann0 face evaluates at its source, `depth` cells inward: the
    # source's taps reach that much further behind along the march and
    # below the tile (the source of a high face lies below it; a low
    # face's source stays inside the tile, which holds two face depths)
    face = [0, 0, 0]
    for op in program.outputs:
        if op.bc is not None and op.bc.kind == "neumann0":
            for a in op.bc.resolved_axes(nd):
                face[axes3[a]] = max(face[axes3[a]], op.bc.depth)
    (bz, by) = shape.tile
    if 2 * face[1] > by or 2 * face[2] > bz:
        raise LayoutRefused(
            f"a neumann0 face of depth {max(face)} needs a tile of at least two face "
            f"depths, got {shape.tile}")
    sweep_reach = _add(reach, ((face[0], face[0]), (face[1], 0), (face[2], 0)))
    stage_read = [_box([to3(s.lo, 0), to3(s.hi, 0)]) for s in program.stages]
    stage_taps = [_box([to3(off, 0) for f, off in s.loads if f in targets])
                  for s in program.stages]
    # backward from the last phase: extents, lags and each reader's reach
    # behind along the march, per producer
    ext: dict = {}
    lag: dict = {}
    readers: dict = {}     # producer -> [(reader, planes behind)]
    zero = ((0, 0),) * 3
    ext[(k - 1, None)], lag[(k - 1, None)] = zero, 0
    for s in range(k - 1, -1, -1):
        for j, rd in enumerate(stage_read):
            ext[(s, j)] = _add(ext[(s, None)], rd)
            lag[(s, j)] = lag[(s, None)] + rd[0][1]
            readers.setdefault((s, j), []).append(((s, None), rd[0][0]))
        if s == 0:
            break
        e = _add(ext[(s, None)], sweep_reach)
        a = lag[(s, None)] + sweep_reach[0][1]
        readers.setdefault((s - 1, None), []).append(((s, None), sweep_reach[0][0]))
        for j, taps in enumerate(stage_taps):
            e = _max(e, _add(ext[(s, j)], taps))
            a = max(a, lag[(s, j)] + taps[0][1])
            readers[(s - 1, None)].append(((s, j), taps[0][0]))
        ext[(s - 1, None)], lag[(s - 1, None)] = e, a
    order = [(s, j) for s in range(k) for j in [*range(len(program.stages)), None]]
    # the first plane (relative to the chunk's first) each phase must
    # compute, and the planes its queue must hold
    need = {(k - 1, None): 0}
    for key in reversed(order[:-1]):
        need[key] = min(need[r] - b for r, b in readers[key])
    lead = max(lag[key] - need[key] for key in order)
    if program.z_strided and shape.slab:
        lead = aligned(lead)       # steps begin on whole sectors of the contiguous axis
    phases = []
    n = len(order)
    if program.layout:
        # a marched layout: a barrier ends every phase but the last, and every
        # queue holds a step of planes more than its readers need
        bar = [i < n - 1 for i in range(n)]
    else:
        # no stage reads another, so the stages of a sweep share one barrier
        bar = [i < n - 1 and not (order[i][1] is not None and order[i + 1][1] is not None)
               for i in range(n)]
    for i, key in enumerate(order):
        slots = 0
        for r, b in readers.get(key, []):
            # a reader holds the planes from `b` behind its own to the newest
            # the producer wrote; where no barrier stands between the
            # reader's phase of one step and the producer's of the next, the
            # producer would overwrite a plane still being read, so its
            # queue holds a step of planes more
            j = order.index(r)
            apart = program.layout or not (any(bar[j:n - 1]) or any(bar[:i]))
            slots = max(slots, lag[key] - lag[r] + b + P + (P if apart else 0))
        (_, (ylo, yhi), (zlo, zhi)) = ext[key]
        phases.append(Phase(key[0], key[1], (ylo, yhi, zlo, zhi), lag[key], slots, bar[i]))
    # planes a chunk reads beyond its own: the lead and what the phases
    # read behind it, the lags and what they read ahead
    far = lead + max(lag.values()) + P + 2 * max(sum(r[0]) for r in [sweep_reach, *stage_taps])
    return Plan(k, tuple((op.name, rotations[op.name]) for op in program.outputs),
                tuple(phases), lead, far)


def queue_words(pl: Plan, ph: Phase, shape: KernelShape, itemsize: int = 4) -> int:
    """4-byte words of one queue of phase ``ph``: a stage's of f32, an
    output's of ``itemsize``-byte storage (rounded up to whole words)."""
    cells = ph.slots * math.prod(pl.region(ph, shape))
    return cells if ph.stage is not None else -(-cells * itemsize // 4)


def field_boxes(program: TapProgram, pl: Plan) -> dict:
    """A k-step kernel marching the contiguous axis (``z_strided``): per
    field that a phase reads from device memory (sweep 0's fields, and the
    fields that do not rotate at every sweep), ``(lo, hi)`` on the kernel's
    axes: the cells around a written cell of the step at which any phase
    reads it (its planes ``lag`` ahead, its tile widened by ``ext``, the
    taps of its core, direct and stage programs, an intermediate sweep's
    previous value, the last sweep's reduction operands), widened as the
    plan widens a sweep's reach for ``neumann0`` faces. What its field
    queue holds (``codegen.slab_queues``)."""
    to3 = program.to3
    src_of = {t for _, t in pl.rotations}
    outs = {op.name for op in program.outputs}
    face = [0, 0, 0]
    for op in program.outputs:
        if op.bc is not None and op.bc.kind == "neumann0":
            for a in op.bc.resolved_axes(program.ndim):
                face[program.axes3[a]] = max(face[program.axes3[a]], op.bc.depth)
    boxes: dict = {}
    last = pl.phases[-1]
    for ph in pl.phases:
        ylo, yhi, zlo, zhi = ph.ext
        taps = []
        if ph.stage is not None:
            taps += program.stages[ph.stage].loads
        else:
            taps += program.core.loads
            taps += [t for op in program.outputs for t in op.loads]
            if ph is last:
                taps += [(f, (0,) * program.ndim) for _, r in program.reductions
                         for f in r.operands if f not in outs]
            else:
                taps += [(t, (0,) * program.ndim) for _, t in pl.rotations]
        for f, off in taps:
            if ph.sweep and f in src_of:
                continue                 # from the previous sweep's queue
            d = to3(off, 0)
            lo = (ph.lag + d[0] - face[0], d[1] - ylo - face[1], d[2] - zlo - face[2])
            hi = (ph.lag + d[0] + face[0], d[1] + yhi, d[2] + zhi)
            b = boxes.get(f)
            boxes[f] = (lo, hi) if b is None else (tuple(map(min, b[0], lo)),
                                                   tuple(map(max, b[1], hi)))
    return boxes


def shared_bytes(program: TapProgram, pl: Plan, shape: KernelShape,
                 dtype: torch.dtype = torch.float32) -> int:
    """Dynamic shared memory of one block (the phases' queues, each output's
    at its storage width; marching the contiguous axis also the field
    queues of f32 and two step buffers of the outputs, 4 bytes a value
    counted) and the reduction fold's static words."""
    isz = storage(dtype).itemsize
    words = 0
    queue = queue_words if program.layout else parallel_queue_words
    for ph in pl.phases:
        per = len(program.outputs) if ph.stage is None else 1
        words += per * queue(pl, ph, shape, isz)
    if program.z_strided and shape.slab:
        words += sum(plane_words(math.prod(_tile(b, shape)), shape.planes)
                     * ring_planes(b, shape.planes) for b in field_boxes(program, pl).values())
        words += 2 * len(program.outputs) * shape.planes * out_row(shape)
    return 4 * (words + len(program.reductions) * (shape.threads // 32))


def _tile(box, shape: KernelShape) -> tuple[int, int]:
    lo, hi = box
    return shape.tile[1] + hi[1] - lo[1], shape.tile[0] + hi[2] - lo[2]


def steps_shape(program: TapProgram, rotations: Mapping[str, str], nsteps: int,
                async_copies: bool = True, dtype: torch.dtype = torch.float32) -> KernelShape:
    """The layout of a program's k-step kernel: the fastest without register
    spills over the candidates of ``launch/tune_stencil.py --steps`` on the
    H100 (PERF.md). All-parallel, :func:`parallel_shape` (:data:`PARALLEL`:
    GP's fused update 32 x 16 cells, 256 threads, two planes a step at
    k = 2, 3.19 against 3.50 ms in the 32 x 8 tile before; FIG1's step
    32 x 32, two planes; porosity 224 x 1, four planes, 0.81 against 1.20
    ms at k = 2). A bf16 or f16 kernel takes its f32 twin's tile and planes
    (FIG1's k = 4 kernel spilled at 80 registers at f16). Marched
    along a non-contiguous axis, the layout before: two planes per step;
    a 32 x 16 tile for a 3-D program without stages, 32 x 8 with stages,
    one row of 256 cells in 2-D; as many resident blocks as the queues
    leave shared memory for, at most four; one plane per step where two
    would not fit a block's shared memory.
    Marching the contiguous axis, the first of :data:`SLABS` that fits:
    its field queues copy a step's planes per cell, so it takes the
    single-step slab's short tiles and 8 planes a step (without
    ``async_copies``, the strided layout: strided loads and stores)."""
    if program.z_strided and async_copies:
        for tile, planes in SLABS[program.ndim]:
            if (sh := slab_shape(program, rotations, nsteps, tile, planes)) is not None:
                return sh
    if not program.layout:
        return parallel_shape(program, rotations, nsteps, dtype)
    tile = base_tile(program, (32, 8) if program.stages else (32, 16))
    for planes in (2, 1):
        trial = KernelShape(tile, planes, 4)
        smem = shared_bytes(program, plan(program, rotations, nsteps, trial), trial)
        if smem <= SHARED_LIMIT:
            break
    return KernelShape(tile, planes, max(1, min(4, SHARED_LIMIT // max(smem, 1))))


def slab_shape(program: TapProgram, rotations: Mapping[str, str], nsteps: int,
               tile: tuple[int, int], planes: int) -> KernelShape | None:
    """A k-step layout marching the contiguous axis of ``tile`` and
    ``planes``, as many blocks resident as its queues leave shared memory
    for (at most four), or None where they do not fit a block."""
    trial = KernelShape(tile, planes, 4, True, True)
    if trial.threads % planes:
        return None
    smem = shared_bytes(program, plan(program, rotations, nsteps, trial), trial)
    if smem > SHARED_LIMIT:
        return None
    return KernelShape(tile, planes, max(1, min(4, SHARED_LIMIT // smem)), True, True)


def cuda_source(program: TapProgram, rotations: Mapping[str, str], nsteps: int,
                shape: KernelShape | None = None, dtype: torch.dtype = torch.float32) -> str:
    """CUDA C++ source of the ``nsteps``-sweep launch for fields stored as
    ``dtype`` (computed in f32): one ``__global__`` function and the plain
    C entry point ``launch``, with the arguments of the single-step
    kernel's (``codegen.cuda_source``)."""
    if program.ndim > 3:
        raise NotImplementedError("the generated CUDA kernel handles 1-3 dimensions")
    shape = shape or steps_shape(program, rotations, nsteps)
    if not program.layout:
        return _parallel_source(program, rotations, nsteps, shape, dtype)
    st = storage(dtype)
    T = st.ctype
    pl = plan(program, rotations, nsteps, shape)
    smem = shared_bytes(program, pl, shape, dtype)
    if smem > SHARED_LIMIT:
        raise LayoutRefused(
            f"{nsteps} sweeps of this update need {smem} bytes of shared memory per "
            f"block, above the {SHARED_LIMIT} a block can have on the H100; take fewer "
            "steps per launch")
    (bz, by) = shape.tile
    fidx = {f: i for i, f in enumerate(program.fields)}
    classes = shape_classes(program)
    fcls = {f: classes.index(program.to3(o, 0)) for f, o in zip(program.fields, program.offsets)}
    zs = program.z_strided
    n_out, n_red, n_par = len(program.outputs), len(program.reductions), len(program.params)
    rot = dict(pl.rotations)
    src_of = {t: o for o, t in pl.rotations}      # target -> the output rotating into it
    oidx = {op.name: i for i, op in enumerate(program.outputs)}
    dims = ("nx", "ny", "nz")
    strides = stride_names(program)
    # marching the contiguous axis: the fields read from device memory come
    # through field queues, the last phase's outputs go out through a step
    # buffer (the single-step slab's emitters)
    slab = zs and shape.slab
    queues = slab_queues(field_boxes(program, pl), shape, fidx, fcls) if slab else []
    fq = {q.field: q for q in queues}
    lines = []
    w = lines.append
    w("// Generated by repro_torch.kernels.codegen_steps from a traced @parallel update.")
    w(f"// {nsteps} sweeps in one launch: replaces the generic Pallas launch")
    w("// src/repro/kernels/stencil.py::build_stencil_call(nsteps=k, rotations=...).")
    w("// Phases (sweep, stage or outputs): each computes its planes ahead of the")
    w("// written ones over the tile and its halo into a plane queue in shared")
    w("// memory; later sweeps load their rotation targets from those queues.")
    for ph in pl.phases:
        py, pz = pl.region(ph, shape)
        what = "outputs" if ph.stage is None else f"stage {ph.stage}"
        w(f"//   {ph.name}: sweep {ph.sweep} {what}, {py} x {pz} cells per plane, "
          f"lag {ph.lag}, {ph.slots} slots")
    w(f"// lead {pl.lead} planes; {smem} bytes of shared memory per block")
    w(f"// Marched layout: program axis a on kernel axis {program.axes3}[a] (x 0, y 1,")
    w("// z 2)" + ("; z is strided, so a warp's loads are strided" if zs else "") + ".")
    if slab:
        w("// x is the contiguous axis, so what bounds the march is bytes in flight:")
        w("// the fields read from device memory are copied into field queues in")
        w("// shared memory by asynchronous copies, planes fastest, a step ahead, and")
        w("// the last phase's outputs go out from a step buffer, planes fastest,")
        w("// during the next step.")
    w("#include <cstdint>")
    w("#include <cuda_runtime.h>")
    for line in st.includes():
        w(line)
    w("")
    w("namespace {")
    for line in st.helpers():
        w(line)
    w(f"constexpr int kBlockZ = {bz};")
    w(f"constexpr int kBlockY = {by};")
    w("constexpr int kThreads = kBlockZ * kBlockY;")
    w("constexpr int kWarps = kThreads / 32;")
    w(f"constexpr int kPlanes = {shape.planes};  // planes per step")
    w(f"constexpr int kLead = {pl.lead};")
    w(f"constexpr int kShared = {smem - 4 * n_red * (shape.threads // 32)};  // dynamic bytes")
    w("")
    if slab:
        w("constexpr int kGroups = kThreads / kPlanes;  // threads per plane of a copy or store")
        w(f"constexpr int kOutRow = {out_row(shape)};  // words of a step buffer's plane")
        w("")
        for line in ring_helper() + [""] + copy_helpers(st):
            w(line)
        w("")
    w("__device__ __forceinline__ int slot(int x, int q) {")
    w("  const int r = x % q;")
    w("  return r < 0 ? r + q : r;")
    w("}")
    w("")
    w("// max that propagates NaN, as torch.amax does")
    w("__device__ __forceinline__ float max_nan(float a, float b) {")
    w("  return (b != b || b > a) ? b : a;")
    w("}")
    w("")
    params = [f"const {T}* __restrict__ in{i}" for i in range(len(program.fields))]
    params += [f"{T}* __restrict__ out{i}" for i in range(n_out)]
    params += [f"float* __restrict__ part{i}" for i in range(n_red)]
    divs = divisor_params(program)
    params += [f"const float p{i}" for i in range(n_par)]
    params += [f"const float r{i}" for i in divs]
    params += [f"const int64_t {n}" for n in (*dims, *strides, "xc")]
    w(f"__global__ void __launch_bounds__(kThreads, {shape.min_blocks}) stencil_kernel(")
    w("    " + ",\n    ".join(params) + ") {")
    w("  extern __shared__ float smem[];")
    w("  const int tz = threadIdx.x, ty = threadIdx.y;")
    w("  const int tid = ty * kBlockZ + tz;")
    block_origin(w, program)
    w("  const int x1 = min(x0 + static_cast<int>(xc), static_cast<int>(nx));")
    w("  const int NX = static_cast<int>(nx), NY = static_cast<int>(ny), "
      "NZ = static_cast<int>(nz);")
    for c, off in enumerate(classes):
        if any(off):
            w(f"  // shape class {c}: base extents less {off}")
        for ax, n, d in zip("xyz", dims, off):
            w(f"  const int m{c}{ax} = static_cast<int>({n})" + (f" - {d};" if d else ";"))
        _emit_strides(w, c, zs)
    for f, i in fidx.items():
        w(f"  const {T}* __restrict__ g{i} = in{i} + b{fcls[f]};")
    for i, op in enumerate(program.outputs):
        w(f"  {T}* __restrict__ h{i} = out{i} + b{fcls[op.name]};")
    _emit_core_box(w, program, fcls)
    # the queues: a stage's of f32, an output's of the storage type, each at
    # a whole number of 4-byte words into the block's shared memory
    offset = 0
    qname = {}
    for ph in pl.phases[:-1]:
        py, pz = pl.region(ph, shape)
        for q in ([op.name for op in program.outputs] if ph.stage is None else [None]):
            name = f"q{ph.name}" + ("" if q is None else f"_{oidx[q]}")
            qname[(ph.name, q)] = name
            if q is None or st.wide:
                w(f"  float* const {name} = smem + {offset};  // {ph.slots} x {py} x {pz}")
            else:
                w(f"  {T}* const {name} = reinterpret_cast<{T}*>(smem + {offset});  "
                  f"// {ph.slots} x {py} x {pz}")
            offset += queue_words(pl, ph, shape, st.itemsize)
    for q in queues:
        w(f"  // field {q.field}: cells {q.lo} to {q.hi} around a written cell")
        w(f"  float (*const smf{q.index})[{q.words}] = reinterpret_cast<float (*)[{q.words}]>("
          f"smem + {offset});  // {q.slots} x {q.rows} x {q.cols}, padded")
        offset += q.words * q.slots
    if slab:
        w("  // each output's step of planes, as stored, in two buffers: one written")
        w("  // while the other goes out")
        for i in range(n_out):
            w(f"  {T} (*const smo{i})[kPlanes][kOutRow] = reinterpret_cast<{T} (*)[kPlanes]"
              f"[kOutRow]>(smem + {offset});")
            offset += 2 * shape.planes * out_row(shape)
        _emit_copy_setup(w, queues, shape)
    for r in range(n_red):
        w(f"  float acc{r} = 0.0f;")
    by_key = {(ph.sweep, ph.stage): ph for ph in pl.phases}

    def queue_at(ph, q, X, Y, Z, off):
        """The element of phase ``ph``'s queue ``q`` at the cell (X, Y, Z)
        moved by ``off``."""
        py, pz = pl.region(ph, shape)
        ylo, zlo = ph.ext[0], ph.ext[2]
        dx, dy, dz = off
        xs_ = f"{X} + {dx}" if dx else X
        row = f"({Y} - y0 + {ylo + dy})" if ylo + dy else f"({Y} - y0)"
        col = f"{Z} - z0 + {zlo + dz}" if zlo + dz else f"{Z} - z0"
        at = (f"{qname[(ph.name, q)]}[slot({xs_}, {ph.slots}) * {py * pz} + "
              f"{row} * {pz} + {col}]")
        return at if q is None else st.widen(at)

    def global_at(f, X, Y, Z, off):
        c = fcls[f]
        if (X, Y, Z) == ("x", "y", "z"):
            return st.widen(f"g{fidx[f]}[{_offset(f'at{c}', c, off, 'S', zs)}]")
        dx, dy, dz = off
        return st.widen(f"g{fidx[f]}[({X} - x0 + {dx}) * S{c}x + ({Y} - y0 + {dy}) * S{c}y + "
                        f"{_zs(f'({Z} - z0 + {dz})', c, zs)}]")

    def field_at(f, X, Y, Z, off):
        """A field read from device memory: from its field queue where it has one."""
        if f not in fq:
            return global_at(f, X, Y, Z, off)
        q, (dx, dy, dz) = fq[f], off
        return (f"smf{q.index}[ring(fb{q.index} + {X} + {dx - q.ahead} - xs, {q.slots})]"
                f"[({Y} - y0 + {dy - q.lo[1]}) * {q.cols} + {Z} - z0 + {dz - q.lo[2]}]")

    def access_for(sweep):
        def access(f, coords, off):
            if sweep > 0 and f in src_of:
                return queue_at(by_key[(sweep - 1, None)], src_of[f], *coords, off)
            return field_at(f, *coords, off)
        return access

    last = pl.phases[-1]
    nt = shape.threads
    if slab:
        w("  // each field queue's slot of the first plane of the window a step reads")
        w("  int " + ", ".join(f"fb{q.index} = 0" for q in queues) + ";")
        w("  int cur = 0;  // the step buffer this step writes")
        w("  int xs = x0 - kLead;")
        w("  // the planes behind the first step's, then its own")
        _emit_copies(w, queues, shape, st, "  ", "xs", "{b}", behind=True)
        _emit_copies(w, queues, shape, st, "  ", "xs", "{b}")
        w("  commit_copies();")
        w("  #pragma unroll 1")
        w("  for (; xs < x1; xs += kPlanes) {")
        w("    wait_copies();")
        w("    __syncthreads();")
        w("    if (xs + kPlanes < x1) {  // the next step's planes, in flight while this one computes")
        _emit_copies(w, queues, shape, st, "      ", "xs + kPlanes", "{b} + kPlanes")
        w("    }")
        w("    commit_copies();")
        w("    if (xs != x0 - kLead) {  // the previous step's outputs")
        _emit_step_store(w, program, shape, fcls, "      ", "xs - kPlanes", "cur ^ 1")
        w("    }")
    else:
        w("  #pragma unroll 1")
        w(f"  for (int xs = x0 - kLead; xs < x1; xs += kPlanes) {{")
    for ph in pl.phases:
        py, pz = pl.region(ph, shape)
        n = py * pz
        is_last = ph is last
        access = access_for(ph.sweep)
        ylo, yhi, zlo, zhi = ph.ext
        if ph.stage is None:
            body = _out_body(program, ph, is_last, access, fidx, fcls, classes, qname, oidx,
                             by_key, queue_at, global_at, rot, st, slab)
            fast = [f"xa >= cxlo", "xa + kPlanes <= cxhi", f"y0 - {ylo} >= cylo",
                    f"y0 + {by + yhi} <= cyhi", f"z0 - {zlo} >= czlo", f"z0 + {bz + zhi} <= czhi"]
            if is_last:
                fast += ["xa >= x0", "xa + kPlanes <= x1"]
        else:
            body = None
            tx, ty_, tz_ = program.to3(program.stages[ph.stage].trim, 0)
            fast = ["xa >= 0", f"xa + kPlanes <= NX - {tx}", f"y0 - {ylo} >= 0",
                    f"y0 + {by + yhi} <= NY - {ty_}", f"z0 - {zlo} >= 0",
                    f"z0 + {bz + zhi} <= NZ - {tz_}"]
        w(f"    {{  // {ph.name}")
        w(f"      const int xa = xs + {ph.lag};" if ph.lag else "      const int xa = xs;")
        # the fast path: every cell of the step's planes lies in the core (or
        # the intermediate's frame), so the cells run one program, unrolled
        # and without a branch, into registers first and stored after, so
        # that no store stands between one cell's loads and the next's; the
        # registers hold f32 (an output rounded to storage, widened back):
        # at FIG1's k = 4 and 32 registers, 2-byte arrays spilled where f32
        # ones did not (on the H100, PERF.md)
        ni = -(-n // nt)
        names = [f"rv{i}" for i in range(n_out)] if ph.stage is None else ["rt"]
        w(f"      if ({' && '.join(fast)}) {{")
        for r in names:
            w(f"        float {r}[kPlanes * {ni}];")
        for part in ("compute", "store"):
            w("        #pragma unroll")
            w("        for (int p = 0; p < kPlanes; ++p) {")
            w("          const int x = xa + p;")
            if part == "store" and not is_last:
                w(f"          const int sl = slot(x, {ph.slots}) * {n};")
            w("          #pragma unroll")
            w(f"          for (int ie = 0; ie < {ni}; ++ie) {{")
            w("            const int e = tid + ie * kThreads;")
            w(f"            if (ie < {n // nt} || e < {n}) {{" if n % nt else "            {")
            ind = "              "
            if part == "compute":
                _emit_cell_coords(w, ind, ph, py, pz)
                if ph.stage is not None:
                    _emit_stage_cell(w, ind, program, ph, qname, access, fcls, frame=False,
                                     into=f"rt[p * {ni} + ie]")
                else:
                    body(w, ind, fast=True, into=f"[p * {ni} + ie]")
            elif ph.stage is not None:
                w(f"{ind}{qname[(ph.name, None)]}[sl + e] = rt[p * {ni} + ie];")
            elif not is_last:
                for i, op in enumerate(program.outputs):
                    w(f"{ind}{qname[(ph.name, op.name)]}[sl + e] = "
                      f"{st.narrow(f'rv{i}[p * {ni} + ie]')};")
            elif slab:
                for i in range(n_out):
                    w(f"{ind}smo{i}[cur][p][e] = {st.narrow(f'rv{i}[p * {ni} + ie]')};")
            else:
                _emit_cell_coords(w, ind, ph, py, pz)
                for i, op in enumerate(program.outputs):
                    c = fcls[op.name]
                    w(f"{ind}h{i}[(x - x0) * S{c}x + (y - y0) * S{c}y + {_zs('(z - z0)', c, zs)}] = "
                      f"{st.narrow(f'rv{i}[p * {ni} + ie]')};")
            w("            }")
            w("          }")
            w("        }")
        w("      } else {")
        w("        #pragma unroll 1")
        w("        for (int p = 0; p < kPlanes; ++p) {")
        w("          const int x = xa + p;")
        if is_last:
            w("          if (x < x0 || x >= x1) continue;")
        else:
            w(f"          const int sl = slot(x, {ph.slots}) * {n};")
        w("          #pragma unroll 1")
        w(f"          for (int e = tid; e < {n}; e += kThreads) {{")
        _emit_cell_coords(w, ind, ph, py, pz)
        if ph.stage is not None:
            _emit_stage_cell(w, ind, program, ph, qname, access, fcls, frame=True)
        else:
            w(f"{ind}if (x < 0 || x >= NX || y < 0 || y >= NY || z < 0 || z >= NZ) continue;")
            body(w, ind, fast=False)
        w("          }")
        w("        }")
        w("      }")
        w("    }")
        if not is_last:
            w("    __syncthreads();")
    if slab:
        for q in queues:
            w(f"    fb{q.index} = ring(fb{q.index} + kPlanes, {q.slots});")
        w("    cur ^= 1;")
    w("  }")
    if slab:
        w("  __syncthreads();  // the last step's outputs")
        _emit_step_store(w, program, shape, fcls, "  ", "xs - kPlanes", "cur ^ 1")
    if n_red:
        w("  // Fold each reduction over the block: within each warp by shuffles,")
        w("  // then over the warps' values, into the block's own slot of its")
        w("  // partials. No float atomics, so the value is the same on every run.")
        w(f"  __shared__ float red[kWarps * {n_red}];")
        w("  const int lane = tid & 31, warp = tid >> 5;")
        w("  const int64_t bid = (static_cast<int64_t>(blockIdx.z) * gridDim.y + "
          "blockIdx.y) * gridDim.x + blockIdx.x;")
        for r, (_, red) in enumerate(program.reductions):
            shfl = f"__shfl_xor_sync(0xffffffffu, acc{r}, o)"
            w(f"  for (int o = 16; o > 0; o >>= 1) acc{r} = {_combine(red.combine, f'acc{r}', shfl)};")
            w(f"  if (lane == 0) red[{r} * kWarps + warp] = acc{r};")
        w("  __syncthreads();")
        w("  if (warp == 0) {")
        for r, (_, red) in enumerate(program.reductions):
            shfl = f"__shfl_xor_sync(0xffffffffu, a{r}, o)"
            w(f"    float a{r} = lane < kWarps ? red[{r} * kWarps + lane] : 0.0f;")
            w(f"    for (int o = 16; o > 0; o >>= 1) a{r} = {_combine(red.combine, f'a{r}', shfl)};")
            w(f"    if (lane == 0) part{r}[bid] = a{r};")
        w("  }")
    w("}")
    w("")
    w("}  // namespace")
    w("")
    cargs = [f"const void* in{i}" for i in range(len(program.fields))]
    cargs += [f"void* out{i}" for i in range(n_out)]
    cargs += [f"void* part{i}" for i in range(n_red)]
    cargs += [f"float p{i}" for i in range(n_par)] + [f"float r{i}" for i in divs]
    cargs += [f"int64_t {n}" for n in (*dims, *strides, "xc", "gz", "gy", "gx")]
    cargs += ["void* stream"]
    w('extern "C" int launch(' + ", ".join(cargs) + ") {")
    w(f"  const dim3 grid({grid_dims(program)});")
    w("  const dim3 block(kBlockZ, kBlockY, 1);")
    w("  const cudaError_t set = cudaFuncSetAttribute(")
    w("      stencil_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kShared);")
    w("  if (set != cudaSuccess) return static_cast<int>(set);")
    kargs = [f"static_cast<const {T}*>(in{i})" for i in range(len(program.fields))]
    kargs += [f"static_cast<{T}*>(out{i})" for i in range(n_out)]
    kargs += [f"static_cast<float*>(part{i})" for i in range(n_red)]
    kargs += [f"p{i}" for i in range(n_par)] + [f"r{i}" for i in divs]
    kargs += [*dims, *strides, "xc"]
    w("  stencil_kernel<<<grid, block, kShared, static_cast<cudaStream_t>(stream)>>>(")
    w("      " + ", ".join(kargs) + ");")
    w("  return static_cast<int>(cudaGetLastError());")
    w("}")
    w("")
    w('extern "C" const char* error_string(int err) {')
    w("  return cudaGetErrorString(static_cast<cudaError_t>(err));")
    w("}")
    return "\n".join(lines) + "\n"


def _emit_cell_coords(w, ind: str, ph: Phase, py: int, pz: int) -> None:
    """The cell (x, y, z) of element ``e`` of the phase's region."""
    if py == 1:
        w(f"{ind}const int ly = 0, lz = e;")
    else:
        w(f"{ind}const int ly = e / {pz}, lz = e - ly * {pz};")
    w(f"{ind}const int y = y0 - {ph.ext[0]} + ly, z = z0 - {ph.ext[2]} + lz;")


def _out_body(program: TapProgram, ph: Phase, is_last: bool, access, fidx, fcls, classes,
              qname, oidx, by_key, queue_at, global_at, rot, st: Storage, slab: bool = False,
              cell: str = "sl + e"):
    """The printer of an outputs phase at one cell: ``body(w, ind, fast)``
    prints the core program (``fast``: the cell is known to lie in the
    core) or the core/direct split. Each output is rounded to storage
    before it is stored, to device memory or to its queue at ``cell``
    (``slab``: the last phase's to the step buffer)."""
    if is_last:
        def store(i, op, val):
            if slab:
                return f"smo{i}[cur][p][e] = {val};"
            return f"h{i}[at{fcls[op.name]}] = {val};"

        def prev(op, coords):
            return global_at(op.name, *coords, (0, 0, 0))
    else:
        def store(i, op, val):
            return f"{qname[(ph.name, op.name)]}[{cell}] = {val};"

        def prev(op, coords):
            return access(rot[op.name], coords, (0, 0, 0))
    # the last sweep folds the reductions, each output's value as stored
    reds = [fold_line(r, red, [f"v{oidx[f]}" if f in oidx
                               else access(f, ("x", "y", "z"), (0, 0, 0)) for f in red.operands])
            for r, (_, red) in enumerate(program.reductions)] if is_last else []

    def core(w, ind, into=None):
        c = program.core
        for j, (f, off) in enumerate(c.loads):
            w(f"{ind}const float l{j} = {access(f, ('x', 'y', 'z'), program.to3(off, 0))};")
        for j, (si, rel) in enumerate(c.reads):
            sph = by_key[(ph.sweep, si)]
            w(f"{ind}const float u{j} = "
              f"{queue_at(sph, None, 'x', 'y', 'z', program.to3(rel, 0))};")
        ref = _printer("l", "u", "e")
        _emit_ops(w, ind, c.ops, "e", ref)
        for i, (op, res) in enumerate(zip(program.outputs, c.results)):
            val = emit_value(w, ind, i, ref(res), st)
            w(f"{ind}" + (store(i, op, val) if into is None else f"rv{i}{into} = v{i};"))
        for line in reds:
            w(f"{ind}{line}")

    zs = program.z_strided

    def body(w, ind, fast, into=None):
        """``fast``: the cell lies in the core, and its outputs go to the
        registers ``rv{output}{into}`` instead of their stores."""
        for c in range(len(classes)):
            w(f"{ind}const int at{c} = (x - x0) * S{c}x + (y - y0) * S{c}y + "
              f"{_zs('(z - z0)', c, zs)};")
        if fast:
            core(w, ind, into)
            return
        w(f"{ind}if (x >= cxlo && x < cxhi && y >= cylo && y < cyhi && z >= czlo && "
          "z < czhi) {")
        core(w, ind + "  ")
        w(f"{ind}}} else {{")
        for i in range(len(program.outputs)):
            w(f"{ind}  float v{i};")
        _emit_direct(w, program, fidx, fcls, access=access, prev=prev, store=store, st=st)
        for line in reds:
            w(f"{ind}  {line}")
        w(f"{ind}}}")
    return body


def _emit_stage_cell(w, ind: str, program: TapProgram, ph: Phase, qname, access,
                     fcls, frame: bool, into: str | None = None, cell: str = "sl + e") -> None:
    """Stage ``ph.stage`` of sweep ``ph.sweep`` at one element: its program
    inside the intermediate's frame, 0 outside (no written cell reads it),
    stored to its queue at ``cell``; without ``frame`` the element is known
    to lie inside, and its value goes to the register ``into``."""
    s = program.stages[ph.stage]
    tx, ty_, tz_ = program.to3(s.trim, 0)
    cind = ind
    if frame:
        w(f"{ind}float v = 0.0f;")
        w(f"{ind}if (x >= 0 && x < NX - {tx} && y >= 0 && y < NY - {ty_} && z >= 0 && "
          f"z < NZ - {tz_}) {{")
        cind = ind + "  "
    for c in sorted({fcls[f] for f, _ in s.loads}):
        w(f"{cind}const int at{c} = (x - x0) * S{c}x + (y - y0) * S{c}y + "
          f"{_zs('(z - z0)', c, program.z_strided)};")
    for j, (f, off) in enumerate(s.loads):
        w(f"{cind}const float a{j} = {access(f, ('x', 'y', 'z'), program.to3(off, 0))};")
    ref = _printer("a", "?", "t")
    _emit_ops(w, cind, s.ops, "t", ref)
    if frame:
        w(f"{cind}v = {ref(s.result)};")
        w(f"{ind}}}")
        w(f"{ind}{qname[(ph.name, None)]}[{cell}] = v;")
    else:
        w(f"{ind}{into} = {ref(s.result)};")



# ------------------------------------------------------- the all-parallel layout
# Layouts of the all-parallel k-step kernel ((z, y) cells of a block's tile,
# threads of a block, planes per step, blocks of ``__launch_bounds__`` for
# f32 and for 2-byte storage, which caps the registers), by rank and whether
# the program has stages, in order of preference: the first whose queues
# leave shared memory for two blocks an SM. The fastest without spills over
# the candidates of ``launch/tune_stencil.py --steps`` on the H100 (PERF.md,
# section 6): GP's 32 x 16 tile at 64 registers though shared memory holds
# three blocks (at 80 its dirichlet kernel spilled); FIG1's k = 4 kernel
# spilled at 80 registers at f16.
PARALLEL = {(3, True): [((32, 16), 256, 2, 4, 4), ((32, 16), 512, 1, 2, 2),
                        ((32, 16), 256, 1, 2, 2), ((32, 8), 256, 1, 2, 2)],
            (3, False): [((32, 32), 256, 2, 3, 2), ((32, 16), 256, 2, 4, 4),
                         ((32, 16), 256, 1, 2, 2)],
            (2, True): [((224, 1), 256, 4, 4, 4), ((224, 1), 256, 2, 4, 4),
                        ((224, 1), 256, 1, 2, 2)],
            (2, False): [((224, 1), 256, 4, 4, 4), ((224, 1), 256, 2, 4, 4),
                         ((224, 1), 256, 1, 2, 2)]}


@dataclasses.dataclass(frozen=True)
class Frame:
    """Where the all-parallel layout keeps its queues: every queue's planes
    are rows of ``pitch`` words of the block's frame (the tile widened by
    the widest phase's halo, ``ylo`` rows and ``zlo`` columns below the
    tile), so that a cell is one frame index in every queue and a tap of
    any queue is that index plus a constant (a pitch of each queue's own
    width needs an index per queue read: GP's k = 2 kernel then spilled at
    64 registers on the H100)."""

    ylo: int
    zlo: int
    pitch: int

    def rows_below(self, ph: Phase) -> int:
        """The frame rows below a phase's first."""
        return self.ylo - ph.ext[0]


def frame(pl: Plan, shape: KernelShape) -> Frame:
    """The all-parallel layout's :class:`Frame`."""
    ext = [max(ph.ext[a] for ph in pl.phases) for a in range(4)]
    return Frame(ext[0], ext[2], shape.tile[0] + ext[2] + ext[3])


def rounds(pl: Plan, ph: Phase, shape: KernelShape) -> tuple[int, int]:
    """``(rounds, width)``: a phase's cells (one plane of its region) over
    the block's threads, ``width`` cells a round (a whole number of warps,
    the rounds as even as that allows), the last round what is left."""
    n = math.prod(pl.region(ph, shape))
    r = -(-n // shape.threads)
    return r, 32 * -(-n // (32 * r))


def parallel_queue_words(pl: Plan, ph: Phase, shape: KernelShape, itemsize: int = 4) -> int:
    """4-byte words of one queue of phase ``ph`` in the all-parallel layout:
    its slots of its region's rows at the frame's pitch (a stage's of f32,
    an output's of ``itemsize``-byte storage, rounded up to whole words)."""
    cells = ph.slots * pl.region(ph, shape)[0] * frame(pl, shape).pitch
    return cells if ph.stage is not None else -(-cells * itemsize // 4)


def parallel_shape(program: TapProgram, rotations: Mapping[str, str], nsteps: int,
                   dtype: torch.dtype = torch.float32) -> KernelShape:
    """The all-parallel k-step layout of a program for fields stored as
    ``dtype``: the first of :data:`PARALLEL` whose queues (its f32 twin's)
    leave shared memory for two blocks an SM, else the one that keeps the
    most threads resident. ``__launch_bounds__`` holds the table's blocks
    where shared memory holds all of them but one (GP's k = 2 kernel at 64
    registers with three resident), else as many as it holds (GP with
    neumann0 faces spilled at 64 registers with two resident)."""
    wide = storage(dtype).wide
    fits = []
    for tile, threads, planes, b32, b16 in PARALLEL[(max(program.ndim, 2),
                                                     bool(program.stages))]:
        blocks = b32 if wide else b16
        trial = KernelShape(tile, planes, blocks, block=threads)
        room = resident_blocks(program, rotations, nsteps, trial)
        if room:
            fits.append((room * threads, trial if room + 1 >= blocks else
                         dataclasses.replace(trial, min_blocks=room)))
        if room >= 2:
            return fits[-1][1]
    if not fits:
        raise NotImplementedError(
            f"{nsteps} sweeps of this update need more shared memory per block than the "
            f"{SHARED_LIMIT} bytes a block can have on the H100; take fewer steps per launch")
    return max(fits, key=lambda f: f[0])[1]


def resident_blocks(program: TapProgram, rotations: Mapping[str, str], nsteps: int,
                    shape: KernelShape, registers: int | None = None) -> int:
    """Blocks of a k-step layout an SM holds: as many as its shared memory
    and its threads allow, and its registers (``registers`` a thread, as
    ptxas reports them; without, as many as ``__launch_bounds__`` holds
    and more)."""
    smem = shared_bytes(program, plan(program, rotations, nsteps, shape), shape)
    room = min(SHARED_LIMIT // max(smem, 1), 2048 // shape.threads)
    if registers is None:
        return room
    return min(room, 65536 // (shape.threads * (-(-registers // 8) * 8)))


def _parallel_source(program: TapProgram, rotations: Mapping[str, str], nsteps: int,
                     shape: KernelShape, dtype: torch.dtype) -> str:
    """:func:`cuda_source` of the all-parallel layout (module docstring).
    Each round's cell is mapped once a step: mapped once before the march
    it took more registers and measured within 0.6% either way on the H100
    (PERF.md)."""
    st = storage(dtype)
    T = st.ctype
    pl = plan(program, rotations, nsteps, shape)
    smem = shared_bytes(program, pl, shape, dtype)
    if smem > SHARED_LIMIT:
        raise LayoutRefused(
            f"{nsteps} sweeps of this update need {smem} bytes of shared memory per "
            f"block, above the {SHARED_LIMIT} a block can have on the H100; take fewer "
            "steps per launch")
    (bz, by), P, nt = shape.tile, shape.planes, shape.threads
    fr = frame(pl, shape)
    FZ = fr.pitch
    fidx = {f: i for i, f in enumerate(program.fields)}
    classes = shape_classes(program)
    fcls = {f: classes.index(program.to3(o, 0)) for f, o in zip(program.fields, program.offsets)}
    n_out, n_red, n_par = len(program.outputs), len(program.reductions), len(program.params)
    rot = dict(pl.rotations)
    src_of = {t: o for o, t in pl.rotations}
    oidx = {op.name: i for i, op in enumerate(program.outputs)}
    dims = ("nx", "ny", "nz")
    strides = stride_names(program)
    by_key = {(ph.sweep, ph.stage): ph for ph in pl.phases}
    pidx = {ph.name: i for i, ph in enumerate(pl.phases)}
    last = pl.phases[-1]
    lines = []
    w = lines.append
    w("// Generated by repro_torch.kernels.codegen_steps from a traced @parallel update.")
    w(f"// {nsteps} sweeps in one launch: replaces the generic Pallas launch")
    w("// src/repro/kernels/stencil.py::build_stencil_call(nsteps=k, rotations=...).")
    w("// Phases (sweep, stage or outputs): each computes its planes ahead of the")
    w("// written ones over the tile and its halo into a plane queue in shared")
    w("// memory; later sweeps load their rotation targets from those queues.")
    w(f"// A block of {nt} threads owns a {by} x {bz} tile; each thread walks fixed")
    w("// cells of each phase's region, in rounds of whole warps; the queues share")
    w(f"// the frame's pitch of {FZ} words, so a tap is the cell's index plus a constant.")
    for ph in pl.phases:
        py, pz = pl.region(ph, shape)
        what = "outputs" if ph.stage is None else f"stage {ph.stage}"
        r, wd = rounds(pl, ph, shape)
        w(f"//   {ph.name}: sweep {ph.sweep} {what}, {py} x {pz} cells per plane, "
          f"lag {ph.lag}, {ph.slots} slots, {r} rounds of {wd} threads"
          + ("" if ph.barrier else ", no barrier after"))
    w(f"// lead {pl.lead} planes; {smem} bytes of shared memory per block")
    w("#include <cstdint>")
    w("#include <cuda_runtime.h>")
    for line in st.includes():
        w(line)
    w("")
    w("namespace {")
    for line in st.helpers():
        w(line)
    w(f"constexpr int kBlockZ = {bz};")
    w(f"constexpr int kBlockY = {by};")
    w(f"constexpr int kThreads = {nt};")
    w("constexpr int kWarps = kThreads / 32;")
    w(f"constexpr int kPlanes = {P};  // planes per step")
    w(f"constexpr int kLead = {pl.lead};")
    w(f"constexpr int kShared = {smem - 4 * n_red * (nt // 32)};  // dynamic bytes")
    w("")
    w("__device__ __forceinline__ int slot(int x, int q) {")
    w("  const int r = x % q;")
    w("  return r < 0 ? r + q : r;")
    w("}")
    w("")
    w("// a ring slot s in [0, 2n) wrapped into [0, n)")
    w("__device__ __forceinline__ int wrap(int s, int n) {")
    w("  return s >= n ? s - n : s;")
    w("}")
    w("")
    w("// max that propagates NaN, as torch.amax does")
    w("__device__ __forceinline__ float max_nan(float a, float b) {")
    w("  return (b != b || b > a) ? b : a;")
    w("}")
    w("")
    w("// pinned: begin")
    w("// a field's block base held in a register pair, so that a row of its taps")
    w("// is one wide multiply-add from it (and its taps along z immediates)")
    w("template <class T> __device__ __forceinline__ const T* pinned(const T* p) {")
    w('  asm volatile("" : "+l"(p));')
    w("  return p;")
    w("}")
    w("// pinned: end")
    w("")
    params = [f"const {T}* __restrict__ in{i}" for i in range(len(program.fields))]
    params += [f"{T}* __restrict__ out{i}" for i in range(n_out)]
    params += [f"float* __restrict__ part{i}" for i in range(n_red)]
    divs = divisor_params(program)
    params += [f"const float p{i}" for i in range(n_par)]
    params += [f"const float r{i}" for i in divs]
    params += [f"const int64_t {n}" for n in (*dims, *strides, "xc")]
    w(f"__global__ void __launch_bounds__(kThreads, {shape.min_blocks}) stencil_kernel(")
    w("    " + ",\n    ".join(params) + ") {")
    w("  extern __shared__ float smem[];")
    w("  const int tid = threadIdx.x;")
    block_origin(w, program)
    w("  const int x1 = min(x0 + static_cast<int>(xc), static_cast<int>(nx));")
    w("  const int NX = static_cast<int>(nx), NY = static_cast<int>(ny), "
      "NZ = static_cast<int>(nz);")
    for c, off in enumerate(classes):
        if any(off):
            w(f"  // shape class {c}: base extents less {off}")
        for ax, n, d in zip("xyz", dims, off):
            w(f"  const int m{c}{ax} = static_cast<int>({n})" + (f" - {d};" if d else ";"))
        _emit_strides(w, c, False)
    for f, i in fidx.items():
        w(f"  const {T}* __restrict__ g{i} = in{i} + b{fcls[f]};")
        w(f"  const {T}* const pg{i} = pinned(g{i});")
    for i, op in enumerate(program.outputs):
        w(f"  {T}* __restrict__ h{i} = out{i} + b{fcls[op.name]};")
    _emit_core_box(w, program, fcls)
    offset = 0
    qname = {}
    for ph in pl.phases[:-1]:
        py, pz = pl.region(ph, shape)
        for q in ([op.name for op in program.outputs] if ph.stage is None else [None]):
            name = f"q{ph.name}" + ("" if q is None else f"_{oidx[q]}")
            qname[(ph.name, q)] = name
            if q is None or st.wide:
                w(f"  float* const {name} = smem + {offset};  // {ph.slots} x {py} x {FZ}")
            else:
                w(f"  {T}* const {name} = reinterpret_cast<{T}*>(smem + {offset});  "
                  f"// {ph.slots} x {py} x {FZ}")
            offset += parallel_queue_words(pl, ph, shape, st.itemsize)
    for r in range(n_red):
        w(f"  float acc{r} = 0.0f;")

    def inside(ph):
        """The (y, z) and x bounds of a phase's fast cells: the core, or a
        stage's intermediate frame."""
        if ph.stage is None:
            return ("cylo", "cyhi"), ("czlo", "czhi"), ("cxlo", "cxhi")
        tx, ty_, tz_ = program.to3(program.stages[ph.stage].trim, 0)
        return ("0", f"NY - {ty_}"), ("0", f"NZ - {tz_}"), ("0", f"NX - {tx}")

    def terms(off, c):
        """The offset ``off`` (x, y, z) in a field of class ``c``."""
        out = ""
        for d, stride in zip(off, (f"S{c}x", f"S{c}y", "")):
            if d:
                term = str(abs(d)) if not stride else stride if abs(d) == 1 else \
                    f"{abs(d)} * {stride}"
                out += f" {'+' if d > 0 else '-'} {term}"
        return out

    def cell_map(ind, ph, ie):
        """Print round ``ie``'s cell of phase ``ph`` (a thread past the
        phase's cells takes its last): its frame index ``c{ie}`` and, per
        shape class, its offset ``g{class}_{ie}`` from the block's base."""
        py, pz = pl.region(ph, shape)
        nr, wd = rounds(pl, ph, shape)
        e = f"tid + {ie * wd}" if ie else "tid"
        if (ie + 1) * wd > py * pz:
            e = f"min({e}, {py * pz - 1})"
        w(f"{ind}const int ie{ie} = {e};")
        k = fr.rows_below(ph) * FZ + fr.zlo - ph.ext[2]
        if py > 1:
            w(f"{ind}const int iy{ie} = ie{ie} / {pz};")
        row = f"iy{ie} * {FZ - pz} + " if py > 1 and FZ != pz else ""
        w(f"{ind}const int c{ie} = {row}ie{ie}" + (f" + {k};" if k else ";"))
        for c in range(len(classes)):
            row = f"iy{ie} * (S{c}y - {pz}) + " if py > 1 else ""
            off = f" - {ph.ext[0]} * S{c}y" if py > 1 and ph.ext[0] else ""
            w(f"{ind}const int g{c}_{ie} = {row}ie{ie}{off} - {ph.ext[2]};")

    w("  // each thread's cells of each phase: bit r of f the rounds r whose cell")
    w("  // lies in the core (a stage's frame), of a the rounds the thread has a")
    w("  // cell in; s the offset of a cell in the core, a step of planes from its")
    w("  // end at most, whose taps all lie in the fields for each of the step's")
    w("  // planes: the base of a round's loads where its cell is not in the core.")
    for ph in pl.phases:
        i = pidx[ph.name]
        py, pz = pl.region(ph, shape)
        nr, wd = rounds(pl, ph, shape)
        if nr > 32:
            raise LayoutRefused(f"{ph.name}: {nr} rounds of a block's threads; take a "
                                      "smaller tile or more threads")
        n = py * pz
        (ylo_b, yhi_b), (zlo_b, zhi_b), (xlo_b, xhi_b) = inside(ph)
        w(f"  unsigned f{i} = 0u, a{i} = 0u;  // {ph.name}")
        for ie in range(nr):
            e = f"tid + {ie * wd}" if ie else "tid"
            w(f"  if (tid < {min(wd, n - ie * wd)}) {{")
            w(f"    a{i} |= {1 << ie}u;")
            if py == 1:
                w(f"    const int y = y0, z = z0 - {ph.ext[2]} + {e};")
            else:
                w(f"    const int e = {e}, ly = e / {pz};")
                w(f"    const int y = y0 - {ph.ext[0]} + ly, z = z0 - {ph.ext[2]} + e - ly * {pz};")
            w(f"    if (y >= {ylo_b} && y < {yhi_b} && z >= {zlo_b} && z < {zhi_b}) "
              f"f{i} |= {1 << ie}u;")
            w("  }")
        for c in range(len(classes)):
            w(f"  const int s{c}_{i} = (min(max(x0, {xlo_b}), {xhi_b} - kPlanes) - x0) * S{c}x + "
              f"(min(max(y0, {ylo_b}), {yhi_b} - 1) - y0) * S{c}y + "
              f"min(max(z0, {zlo_b}), {zhi_b} - 1) - z0;")
    w("  // each queue's ring slot of the step's first plane, advanced once a step")
    for ph in pl.phases[:-1]:
        w(f"  int rb{pidx[ph.name]} = slot(x0 - kLead, {ph.slots});")

    def plane_slot(ph, d):
        """The ring slot of the plane ``d`` after the step's first in phase
        ``ph``'s queue."""
        i = pidx[ph.name]
        return f"wrap(rb{i} + {d % ph.slots}, {ph.slots})"

    def fast_access(sweep, ie, p, lag, rows):
        """Taps of a fast cell: round ``ie`` at plane ``p`` of the step
        (``lag`` planes ahead of the written ones). A field's
        taps are read through a pointer to their row (``rows``: field, x
        and y offset -> its name), so that a tap along z is an immediate."""
        def access(f, coords, off):
            if sweep > 0 and f in src_of:
                return fast_queue(by_key[(sweep - 1, None)], src_of[f], ie, p, lag, off)
            c = fcls[f]
            dx, dy, dz = off
            key = (fidx[f], p + dx, dy)
            rows.setdefault(key, (f"r{fidx[f]}_{p + dx}_{dy}".replace("-", "m"),
                                  f"pg{fidx[f]} + (b{c}_{ie}{terms((p + dx, dy, 0), c)})"))
            return st.widen(f"__ldg({rows[key][0]}" + (f" + {dz})" if dz > 0 else
                                                       f" - {-dz})" if dz else ")"))
        return access

    def row_pointers(ind, rows):
        for name, at in rows.values():
            w(f"{ind}const {T}* const {name} = {at};")

    def fast_queue(src, q, ie, p, lag, off):
        dx, dy, dz = off
        k = dy * FZ + dz - fr.rows_below(src) * FZ
        at = (f"{qname[(src.name, q)]}[{plane_slot(src, lag + p + dx)} * "
              f"{pl.region(src, shape)[0] * FZ} + c{ie}" + (f" + {k}]" if k > 0 else
                                                           f" - {-k}]" if k else "]"))
        return at if q is None else st.widen(at)

    def slow_queue(ph, q, X, Y, Z, off):
        """A queue's element at the cell (X, Y, Z) moved by ``off``, any cell."""
        dx, dy, dz = off
        i = pidx[ph.name]
        at = (f"{qname[(ph.name, q)]}[slot(rb{i} + {X} + {dx} - xs, {ph.slots}) * "
              f"{pl.region(ph, shape)[0] * FZ} + ({Y} - y0 + {ph.ext[0] + dy}) * {FZ} + "
              f"{Z} - z0 + {fr.zlo + dz}]")
        return at if q is None else st.widen(at)

    def slow_global(f, X, Y, Z, off):
        c = fcls[f]
        if (X, Y, Z) == ("x", "y", "z"):
            return st.widen(f"g{fidx[f]}[{_offset(f'at{c}', c, off, 'S')}]")
        dx, dy, dz = off
        return st.widen(f"g{fidx[f]}[({X} - x0 + {dx}) * S{c}x + ({Y} - y0 + {dy}) * S{c}y + "
                        f"({Z} - z0 + {dz})]")

    def slow_access_for(sweep):
        def access(f, coords, off):
            if sweep > 0 and f in src_of:
                return slow_queue(by_key[(sweep - 1, None)], src_of[f], *coords, off)
            return slow_global(f, *coords, off)
        return access

    w("  #pragma unroll 1")
    w("  for (int xs = x0 - kLead; xs < x1; xs += kPlanes) {")
    for ph in pl.phases:
        i = pidx[ph.name]
        py, pz = pl.region(ph, shape)
        nr, wd = rounds(pl, ph, shape)
        is_last = ph is last
        _, _, (xlo_b, xhi_b) = inside(ph)
        w(f"    {{  // {ph.name}")
        w(f"      const int xa = xs + {ph.lag};" if ph.lag else "      const int xa = xs;")
        conds = [f"xa >= {xlo_b}", f"xa + {P} <= {xhi_b}"]
        if is_last:
            conds += ["xa >= x0", f"xa + {P} <= x1"]
        w(f"      const bool inall = {' && '.join(conds)};  // every plane of the step in the core")
        w(f"      if (inall && f{i}) {{")
        w("        // the fast cells: every load made (a cell off the core loads at s), a")
        w("        // tap a base plus a constant; computed into registers before any store")
        ind = "        "
        for ie in range(nr):
            cell_map(ind, ph, ie)
            w(f"{ind}const bool k{ie} = (f{i} & {1 << ie}u) != 0u;")
            for c in range(len(classes)):
                w(f"{ind}const int b{c}_{ie} = k{ie} ? (xa - x0) * S{c}x + g{c}_{ie} : "
                  f"s{c}_{i};")
        outs_ = [f"rv{o}" for o in range(n_out)] if ph.stage is None else ["rt"]
        cells = [(p, ie) for p in range(P) for ie in range(nr)]
        for r in outs_:
            w(f"{ind}float " + ", ".join(f"{r}_{p}_{ie}" for p, ie in cells) + ";")
        for p, ie in cells:
            w(f"{ind}{{")
            cind = ind + "  "
            rows = {}
            access = fast_access(ph.sweep, ie, p, ph.lag, rows)
            if ph.stage is not None:
                stg = program.stages[ph.stage]
                loads = [access(f, None, program.to3(off, 0)) for f, off in stg.loads]
                row_pointers(cind, rows)
                for j, load in enumerate(loads):
                    w(f"{cind}const float a{j} = {load};")
                ref = _printer("a", "?", "t")
                _emit_ops(w, cind, stg.ops, "t", ref)
                w(f"{cind}rt_{p}_{ie} = {ref(stg.result)};")
            else:
                core = program.core
                loads = [access(f, None, program.to3(off, 0)) for f, off in core.loads]
                reds = [[f"v{oidx[f]}" if f in oidx else access(f, None, (0, 0, 0))
                         for f in red.operands] for _, red in program.reductions] if is_last else []
                row_pointers(cind, rows)
                for j, load in enumerate(loads):
                    w(f"{cind}const float l{j} = {load};")
                for j, (si, rel) in enumerate(core.reads):
                    w(f"{cind}const float u{j} = " + fast_queue(
                        by_key[(ph.sweep, si)], None, ie, p, ph.lag,
                        program.to3(rel, 0)) + ";")
                ref = _printer("l", "u", "e")
                _emit_ops(w, cind, core.ops, "e", ref)
                for o, res in enumerate(core.results):
                    emit_value(w, cind, o, ref(res), st)
                    w(f"{cind}rv{o}_{p}_{ie} = v{o};")
                for r, (_, red) in enumerate(program.reductions if is_last else []):
                    w(f"{cind}if (k{ie}) " + fold_line(r, red, reds[r]))
            w(f"{ind}}}")
        for ie in range(nr):
            w(f"{ind}if (k{ie}) {{")
            for p in range(P):
                at = None if is_last else f"{plane_slot(ph, ph.lag + p)} * {py * FZ} + c{ie}" + (
                    f" - {fr.rows_below(ph) * FZ}" if fr.rows_below(ph) else "")
                if ph.stage is not None:
                    w(f"{ind}  {qname[(ph.name, None)]}[{at}] = rt_{p}_{ie};")
                elif not is_last:
                    for o, op in enumerate(program.outputs):
                        w(f"{ind}  {qname[(ph.name, op.name)]}[{at}] = "
                          f"{st.narrow(f'rv{o}_{p}_{ie}')};")
                else:
                    for o, op in enumerate(program.outputs):
                        c = fcls[op.name]
                        w(f"{ind}  h{o}[b{c}_{ie}{terms((p, 0, 0), c)}] = "
                          f"{st.narrow(f'rv{o}_{p}_{ie}')};")
            w(f"{ind}}}")
        w("      }")
        # the cells off the fast path, one by one
        w(f"      if (!inall || f{i} != a{i}) {{")
        w("        #pragma unroll 1")
        w("        for (int p = 0; p < kPlanes; ++p) {")
        w("          const int x = xa + p;")
        w("          #pragma unroll 1")
        w(f"          for (int ie = 0; ie < {nr}; ++ie) {{")
        w(f"            if (!((a{i} >> ie) & 1u) || (inall && ((f{i} >> ie) & 1u))) continue;")
        ind = "            "
        w(f"{ind}const int e = tid + ie * {wd};")
        if py == 1:
            w(f"{ind}const int ly = 0, lz = e;")
        else:
            w(f"{ind}const int ly = e / {pz}, lz = e - ly * {pz};")
        w(f"{ind}const int y = y0 - {ph.ext[0]} + ly, z = z0 - {ph.ext[2]} + lz;")
        if is_last:
            w(f"{ind}if (x < x0 || x >= x1) continue;")
        else:
            zc = fr.zlo - ph.ext[2]
            w(f"{ind}const int sl = slot(rb{i} + x - xs, {ph.slots}) * {py * FZ} + ly * {FZ} + lz"
              + (f" + {zc};" if zc else ";"))
        access = slow_access_for(ph.sweep)
        if ph.stage is not None:
            _emit_stage_cell(w, ind, program, ph, qname, access, fcls, frame=True, cell="sl")
        else:
            w(f"{ind}if (x < 0 || x >= NX || y < 0 || y >= NY || z < 0 || z >= NZ) continue;")
            body = _out_body(program, ph, is_last, access, fidx, fcls, classes, qname, oidx,
                             by_key, slow_queue, slow_global, rot, st, cell="sl")
            body(w, ind, fast=False)
        w("          }")
        w("        }")
        w("      }")
        w("    }")
        if ph.barrier:
            w("    __syncthreads();")
    for ph in pl.phases[:-1]:
        i = pidx[ph.name]
        w(f"    rb{i} = wrap(rb{i} + kPlanes, {ph.slots});")
    w("  }")
    if n_red:
        w("  // Fold each reduction over the block: within each warp by shuffles,")
        w("  // then over the warps' values, into the block's own slot of its")
        w("  // partials. No float atomics, so the value is the same on every run.")
        w(f"  __shared__ float red[kWarps * {n_red}];")
        w("  const int lane = tid & 31, warp = tid >> 5;")
        w("  const int64_t bid = (static_cast<int64_t>(blockIdx.z) * gridDim.y + "
          "blockIdx.y) * gridDim.x + blockIdx.x;")
        for r, (_, red) in enumerate(program.reductions):
            shfl = f"__shfl_xor_sync(0xffffffffu, acc{r}, o)"
            w(f"  for (int o = 16; o > 0; o >>= 1) acc{r} = {_combine(red.combine, f'acc{r}', shfl)};")
            w(f"  if (lane == 0) red[{r} * kWarps + warp] = acc{r};")
        w("  __syncthreads();")
        w("  if (warp == 0) {")
        for r, (_, red) in enumerate(program.reductions):
            shfl = f"__shfl_xor_sync(0xffffffffu, a{r}, o)"
            w(f"    float a{r} = lane < kWarps ? red[{r} * kWarps + lane] : 0.0f;")
            w(f"    for (int o = 16; o > 0; o >>= 1) a{r} = {_combine(red.combine, f'a{r}', shfl)};")
            w(f"    if (lane == 0) part{r}[bid] = a{r};")
        w("  }")
    w("}")
    w("")
    w("}  // namespace")
    w("")
    cargs = [f"const void* in{i}" for i in range(len(program.fields))]
    cargs += [f"void* out{i}" for i in range(n_out)]
    cargs += [f"void* part{i}" for i in range(n_red)]
    cargs += [f"float p{i}" for i in range(n_par)] + [f"float r{i}" for i in divs]
    cargs += [f"int64_t {n}" for n in (*dims, *strides, "xc", "gz", "gy", "gx")]
    cargs += ["void* stream"]
    w('extern "C" int launch(' + ", ".join(cargs) + ") {")
    w(f"  const dim3 grid({grid_dims(program)});")
    w("  const dim3 block(kThreads, 1, 1);")
    w("  const cudaError_t set = cudaFuncSetAttribute(")
    w("      stencil_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kShared);")
    w("  if (set != cudaSuccess) return static_cast<int>(set);")
    kargs = [f"static_cast<const {T}*>(in{i})" for i in range(len(program.fields))]
    kargs += [f"static_cast<{T}*>(out{i})" for i in range(n_out)]
    kargs += [f"static_cast<float*>(part{i})" for i in range(n_red)]
    kargs += [f"p{i}" for i in range(n_par)] + [f"r{i}" for i in divs]
    kargs += [*dims, *strides, "xc"]
    w("  stencil_kernel<<<grid, block, kShared, static_cast<cudaStream_t>(stream)>>>(")
    w("      " + ", ".join(kargs) + ");")
    w("  return static_cast<int>(cudaGetLastError());")
    w("}")
    w("")
    w('extern "C" const char* error_string(int err) {')
    w("  return cudaGetErrorString(static_cast<cudaError_t>(err));")
    w("}")
    return "\n".join(lines) + "\n"
