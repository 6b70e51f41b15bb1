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

Every phase walks its region cell by cell, each thread taking every
``threads``-th cell. Where the whole region of a step's planes lies in the
core (or, for a stage, in the intermediate's frame), the cells run one
program unrolled and without a branch, all of a thread's cells computed
into registers before any is stored; elsewhere each cell takes the core or
its outputs' direct programs. A barrier ends each phase but the last, and
every queue holds one step of planes more than its readers need, so the
next step never writes a plane still being read.

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

from .codegen import (KernelShape, Storage, TapProgram, _combine, _emit_copies, _emit_copy_setup,
                      _emit_core_box, _emit_direct, _emit_ops, _emit_step_store, _emit_strides,
                      _offset, _printer, _zs, aligned, base_tile, block_origin, copy_helpers,
                      divisor_params, emit_value, fold_line, grid_dims, out_row, plane_words,
                      ring_helper, ring_planes, shape_classes, slab_queues, storage, stride_names)

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
    rotate into their ``rotations`` targets, laid out as ``shape``."""
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
        raise NotImplementedError(
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
    for key in order:
        slots = 0 if key == order[-1] else \
            max(lag[key] - lag[r] + b for r, b in readers[key]) + 2 * P
        (_, (ylo, yhi), (zlo, zhi)) = ext[key]
        phases.append(Phase(key[0], key[1], (ylo, yhi, zlo, zhi), lag[key], slots))
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
    for ph in pl.phases:
        per = len(program.outputs) if ph.stage is None else 1
        words += per * queue_words(pl, ph, shape, isz)
    if program.z_strided and shape.slab:
        words += sum(plane_words(math.prod(_tile(b, shape)), shape.planes)
                     * ring_planes(b, shape.planes) for b in field_boxes(program, pl).values())
        words += 2 * len(program.outputs) * shape.planes * out_row(shape)
    return 4 * (words + len(program.reductions) * (shape.threads // 32))


def _tile(box, shape: KernelShape) -> tuple[int, int]:
    lo, hi = box
    return shape.tile[1] + hi[1] - lo[1], shape.tile[0] + hi[2] - lo[2]


def steps_shape(program: TapProgram, rotations: Mapping[str, str], nsteps: int,
                async_copies: bool = True) -> KernelShape:
    """The layout of a program's k-step kernel: the fastest without register
    spills over the candidates of ``launch/tune_stencil.py --steps`` on the
    H100 (PERF.md). Two planes per step; a 32 x 16 tile for a 3-D
    program without stages (FIG1's step), 32 x 8 with stages (GP's fused
    update, whose cone of staged planes grows fastest), one row of 256
    cells in 2-D; as many resident blocks as the queues leave shared memory
    for, at most four (``__launch_bounds__`` then caps a thread at 64
    registers, 32 for the 512 threads of a 32 x 16 tile). One plane per
    step where two would not fit a block's shared memory (GP with neumann0
    faces at k = 4). A bf16 or f16 kernel takes its f32 twin's layout: its
    2-byte queues need less shared memory, but more blocks would cap its
    registers below what its f32 twin was held to without spills
    (porosity's k = 4 kernel spilled at 4 blocks on the H100, PERF.md).
    Marching the contiguous axis, the first of :data:`SLABS` that fits:
    its field queues copy a step's planes per cell, so it takes the
    single-step slab's short tiles and 8 planes a step (without
    ``async_copies``, the strided layout: strided loads and stores)."""
    if program.z_strided and async_copies:
        for tile, planes in SLABS[program.ndim]:
            if (sh := slab_shape(program, rotations, nsteps, tile, planes)) is not None:
                return sh
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
    st = storage(dtype)
    T = st.ctype
    shape = shape or steps_shape(program, rotations, nsteps)
    pl = plan(program, rotations, nsteps, shape)
    smem = shared_bytes(program, pl, shape, dtype)
    if smem > SHARED_LIMIT:
        raise NotImplementedError(
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
    if program.layout:
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
              qname, oidx, by_key, queue_at, global_at, rot, st: Storage, slab: bool = False):
    """The printer of an outputs phase at one cell: ``body(w, ind, fast)``
    prints the core program (``fast``: the cell is known to lie in the
    core) or the core/direct split. Each output is rounded to storage
    before it is stored, to device memory or to its queue (``slab``: the
    last phase's to the step buffer)."""
    if is_last:
        def store(i, op, val):
            if slab:
                return f"smo{i}[cur][p][e] = {val};"
            return f"h{i}[at{fcls[op.name]}] = {val};"

        def prev(op, coords):
            return global_at(op.name, *coords, (0, 0, 0))
    else:
        def store(i, op, val):
            return f"{qname[(ph.name, op.name)]}[sl + e] = {val};"

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
                     fcls, frame: bool, into: str | None = None) -> None:
    """Stage ``ph.stage`` of sweep ``ph.sweep`` at one element: its program
    inside the intermediate's frame, 0 outside (no written cell reads it);
    without ``frame`` the element is known to lie inside, and its value
    goes to the register ``into``."""
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
        w(f"{ind}{qname[(ph.name, None)]}[sl + e] = v;")
    else:
        w(f"{ind}{into} = {ref(s.result)};")

