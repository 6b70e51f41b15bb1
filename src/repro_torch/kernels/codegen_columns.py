"""The column march of the batched generated kernel (the sample axis of a
batched solve), for 3-D programs without stages: the serving demo's
diffusion step and its guarded check, at f32 and at 2 bytes.

:func:`codegen.cuda_source` prints this layout for a batched launch whose
:class:`~codegen.KernelShape` has ``column`` set. It runs
the same tap program as the one-cell batched layout (the same core and
direct programs, the same operations in the same order on every cell, the
same per-sample prologue of ``codegen._emit_sample``), laid out for the
H100:

* a block owns a (z, y) tile of ONE sample, threadIdx.x along the
  contiguous z so a warp's rows coalesce, and marches x over a chunk of
  its column (``stencil.BATCH_COLUMN_WAVES`` waves of blocks: 16-26 planes
  of a 128^3 sample at B = 16), so the per-sample prologue (the live flag,
  the parity, the scalars' row) is paid once a chunk;
* the march runs in three loops: the planes before the core and after it
  through each output's direct program, and the core's planes without a
  branch a plane, ``shape.planes`` of them unrolled. Where no boundary
  condition lies along y or z (:func:`kept_ring`) every thread runs the
  core loop, the cells of the (y, z) ring kept by predication: a thread
  that left its warp for the direct program ran its column alone, each
  plane waiting on its own loads, and its warp waited (PERF.md, section 6);
* every field the core program reads along x at the cell's own (y, z)
  lives in a register ring (the Laplacian's T[x-1], T[x], T[x+1]): each
  plane costs one load, ``shape.ahead`` planes beyond the taps, and the x
  neighbours no second load;
* the taps at other (y, z) come through the read-only path (``__ldg``,
  ``ld.global.nc``) off a 64-bit pointer to each tap row advanced a plane
  at a time, the neighbouring threads' loads of the same rows served by
  L1, as the hand kernel ``csrc/diffusion3d.cu`` loads them (a plane tile
  in shared memory filled by ``cp.async``, one barrier a plane, ran 20-75%
  slower on the H100: PERF.md, section 6);
* no output is read at a shift (``codegen.check_batched``), and a cell of
  an output that keeps its previous value (the kept ring, the edges of a
  bc that only some axes take) is neither stored nor, unless a reduction
  folds it, loaded (``codegen._emit_direct``'s ``in_place``): the batched
  launch writes its outputs in place, so the ring already holds its bits
  and no cell that is read is written during the launch.

What bounds it on the H100: bytes. The diffusion step reads T and writes
T2's interior once, 8 bytes a cell at f32, for 11 operations; the core
loop spends about 40 instructions a cell (62 with the guard). Reductions
fold in registers over the chunk and once per block, as the one-cell
layout folds them, one partial per (sample, block).
"""
from __future__ import annotations

import math
from typing import Mapping

from . import codegen
from .codegen import KernelShape, Storage, TapProgram

def ring_taps(program: TapProgram) -> dict[str, tuple[int, int]]:
    """``{field: (lo, hi)}``: the x shifts at which the core program reads
    each field at the cell's own (y, z), the planes of its register ring."""
    out: dict[str, tuple[int, int]] = {}
    for f, off in program.core.loads:
        dx, dy, dz = program.to3(off, 0)
        if dy == 0 and dz == 0:
            lo, hi = out.get(f, (dx, dx))
            out[f] = (min(lo, dx), max(hi, dx))
    return out


def kept_ring(program: TapProgram, fcls) -> bool:
    """Whether every cell of a core plane outside the core's (y, z) box keeps
    its value: the outputs share one shape class and one ring along y and
    along z and take no boundary condition along either."""
    outs = program.outputs
    return (len({fcls[op.name] for op in outs}) == 1
            and all(len({program.to3(op.rings, 0)[a] for op in outs}) == 1 for a in (1, 2))
            and not any(op.bc and {1, 2} & {program.axes3[a] for a in
                                            op.bc.resolved_axes(program.ndim)} for op in outs))


def fold(r: int, red, vals) -> str:
    """``codegen.fold_line``, but the ``finite`` guard's max of 0s and 1s,
    which are never NaN, as one ``fmaxf``: the same value, without the
    NaN test on the chain the march carries from plane to plane."""
    if red.kind == "finite":
        return f"acc{r} = fmaxf(acc{r}, fabsf({vals[0]}) < {codegen.float_literal(math.inf)} " \
               "? 0.0f : 1.0f);"
    return codegen.fold_line(r, red, vals)


def plus(e: str, d: int) -> str:
    """``e`` moved by ``d``, as C."""
    return f"{e} + {d}" if d > 0 else f"{e} - {-d}" if d < 0 else e


def shared_bytes(program: TapProgram, shape: KernelShape) -> int:
    """Static shared memory of one block: the reduction fold's one value
    per warp and reduction."""
    return 4 * len(program.reductions) * (shape.threads // 32)


def check(program: TapProgram, shape: KernelShape) -> None:
    """``ValueError`` unless the column march can print ``program``."""
    if program.ndim != 3 or program.stages or program.layout or shape.vec > 1 or shape.slab:
        raise ValueError("the column march takes a 3-D all-parallel program without stages, "
                         f"one cell a thread, not {codegen.layout_name(shape)}")


def cuda_source(program: TapProgram, shape: KernelShape, st: Storage,
                batched: Mapping[str, str]) -> str:
    """CUDA C++ of the batched column march (module docstring): the batched
    kernel's arguments and entry point (``codegen._emit_entry``), a block
    a (z, y) tile of one sample marching its chunk of x planes one at a
    time, ``shape.planes`` of them unrolled."""
    check(program, shape)
    codegen.check_batched(program, batched)
    (bz, by) = shape.tile
    fidx = {f: k for k, f in enumerate(program.fields)}
    classes = codegen.shape_classes(program)
    fcls = {f: classes.index(program.to3(o, 0)) for f, o in zip(program.fields, program.offsets)}
    n_red = len(program.reductions)
    divs = codegen.divisor_params(program)
    core = program.core
    rings = ring_taps(program)
    ahead = shape.ahead
    paired = set(batched) | set(batched.values())
    T = st.ctype
    lines: list[str] = []
    w = lines.append
    w("// Generated by repro_torch.kernels.codegen_columns from a traced @parallel update.")
    w("// Replaces the generic Pallas launch src/repro/kernels/stencil.py::")
    w("// build_stencil_call for this update, batched: fields are stacked (B, *grid)")
    w("// and blockIdx.z runs over (sample, chunk). A block owns a (y, z) tile of one")
    w("// sample, threadIdx.x along z (the contiguous axis), and marches its chunk of")
    w("// x planes one at a time, keeping each field's taps along x in a register")
    w("// ring; the taps at other (y, z) come through the read-only path (__ldg)."
      + (f" Loads run {ahead} planes further ahead." if ahead else ""))
    w("// What bounds it on the H100 is bytes: every field is read once through the")
    w("// read-only path and every written cell stored once. Each rotation's two")
    w("// buffers swap per sample by its parity; a live sample's outputs are written")
    w("// in place, a cell that keeps its value is not stored, a dead sample's blocks")
    w("// return at once. Scalars are per sample, partials per (sample, block).")
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
    w("")
    w("// max that propagates NaN, as torch.amax does")
    w("__device__ __forceinline__ float max_nan(float a, float b) {")
    w("  return (b != b || b > a) ? b : a;")
    w("}")
    w("")
    params = [p for k, f in enumerate(program.fields)
              for p in ([f"{T}* in{k}", f"{T}* alt{k}"] if f in paired
                        else [f"const {T}* __restrict__ in{k}"])]
    params += [f"float* __restrict__ part{k}" for k in range(n_red)]
    params += ["const float* __restrict__ prm", "const bool* __restrict__ live",
               "const bool* __restrict__ odd", "const int flip"]
    params += [f"const int64_t {n}" for n in ("nx", "ny", "nz", *codegen.stride_names(program),
                                              "xc")]
    w(f"__global__ void __launch_bounds__(kThreads, {shape.min_blocks}) stencil_kernel(")
    w("    " + ",\n    ".join(params) + ") {")
    w("  const int tz = threadIdx.x, ty = threadIdx.y;")
    w("  const int tid = ty * kBlockZ + tz;")
    codegen._emit_sample(w, program, divs)
    w("  const int x1 = min(x0 + static_cast<int>(xc), static_cast<int>(nx));")
    w("  const int y = y0 + ty, z = z0 + tz;")
    for c, off in enumerate(classes):
        if any(off):
            w(f"  // shape class {c}: base extents less {off}")
        for ax, n, d in zip("xyz", ("nx", "ny", "nz"), off):
            w(f"  const int m{c}{ax} = static_cast<int>({n})" + (f" - {d};" if d else ";"))
        codegen._emit_strides(w, c, False, sample=True)
    w("  // every field is read through the read-only path: no cell that is read")
    w("  // is written during the launch")
    for f, k in fidx.items():
        src = f"(par ? alt{k} : in{k})" if f in paired else f"in{k}"
        w(f"  const {T}* const g{k} = {src} + b{fcls[f]};")
    for k, op in enumerate(program.outputs):
        j = fidx[op.name]
        w(f"  {T}* const h{k} = (par ? alt{j} : in{j}) + b{fcls[op.name]};")
    codegen._emit_core_box(w, program, fcls)
    w("  const bool in_grid = y < ny && z < nz;")
    w("  const bool yz_core = y >= cylo && y < cyhi && z >= czlo && z < czhi;")
    ring_cls = sorted({fcls[f] for f in rings})
    for c in ring_cls:
        w(f"  const bool col{c} = y < m{c}y && z < m{c}z;  // the column lies in class {c}")
    for r in range(n_red):
        w(f"  float acc{r} = 0.0f;")

    def ldg(f: str, off: str) -> str:
        return st.widen(f"__ldg(g{fidx[f]} + {off})")

    def ring_load(f: str, plane: str) -> str:
        # plane `plane` of field f at the thread's column, 0 outside the field
        c = fcls[f]
        return (f"col{c} && {plane} >= 0 && {plane} < m{c}x ? "
                f"{ldg(f, f'({plane} - x0) * S{c}x + ty * S{c}y + tz')} : 0.0f")

    # the register rings: r{k}_{i} holds plane x + lo + i of field k, up to
    # the taps' reach and ``ahead`` planes more
    for f, (lo, hi) in rings.items():
        k = fidx[f]
        w(f"  // field {f}: planes {plus('x', lo)} .. {plus('x', hi + ahead)} in registers")
        w(f"  float {', '.join(f'r{k}_{i}' for i in range(hi + ahead - lo + 1))};")
        for i in range(hi + ahead - lo):
            w(f"  r{k}_{i} = {ring_load(f, f'({plus('x0', lo + i)})')};")

    out_idx = {op.name: k for k, op in enumerate(program.outputs)}
    # every thread runs the core loop over the core's planes, the cells of
    # the (y, z) ring kept by predication, instead of sending their threads
    # through the direct program a plane at a time, each plane waiting on
    # its own loads, apart from their warps
    keep = kept_ring(program, fcls)
    # the rows a core cell reads: a pointer to each (field, dx, dy) that a tap
    # off its ring lies on (its z shift a constant offset), each ring's far
    # plane, and each field a reduction folds at the cell; advanced a plane
    # at a time by the field's 64-bit x stride
    rows: dict = {}
    for f, off in core.loads:
        d = program.to3(off, 0)
        if not (f in rings and d[1:] == (0, 0)):
            rows.setdefault((f, d[0], d[1]), f"t{len(rows)}")
    for f, (lo, hi) in rings.items():
        rows.setdefault((f, hi + ahead, 0), f"t{len(rows)}")
    for _, red in program.reductions:
        for f in red.operands:
            if f not in out_idx and not (f in rings and rings[f][0] <= 0 <= rings[f][1]):
                rows.setdefault((f, 0, 0), f"t{len(rows)}")

    def start_rows(ind: str, xs: str) -> None:
        # every row pointer, and each output's, at plane xs
        for (f, dx, dy), name in rows.items():
            k, c = fidx[f], fcls[f]
            w(f"{ind}const {T}* {name} = g{k} + (({plus(f'{xs} - x0', dx)}) * S{c}x + "
              f"({plus('ty', dy)}) * S{c}y + tz);  // field {f} at {plus('x', dx)}, {plus('y', dy)}")
        for k, op in enumerate(program.outputs):
            c = fcls[op.name]
            w(f"{ind}{T}* o{k} = h{k} + (({xs} - x0) * S{c}x + ty * S{c}y + tz);")

    def advance(ind: str) -> None:
        steps = [f"{name} += s{fcls[f]}x;" for (f, _, _), name in rows.items()]
        steps += [f"o{k} += s{fcls[op.name]}x;" for k, op in enumerate(program.outputs)]
        w(f"{ind}" + " ".join(steps))

    def operand(f: str, core_cell: bool) -> str:
        # a reduction's operand at a cell: an output's value, else the
        # field's own cell (at a core cell from its ring where it holds x)
        if f in out_idx:
            return f"{'w' if core_cell and keep else 'v'}{out_idx[f]}"
        if core_cell and f in rings and rings[f][0] <= 0 <= rings[f][1]:
            return f"r{fidx[f]}_{-rings[f][0]}"
        if core_cell:
            return st.widen(f"__ldg({rows[(f, 0, 0)]})")
        return ldg(f, f"at{fcls[f]}")

    def reds(core_cell: bool) -> list[str]:
        return [fold(r, red, [operand(f, core_cell) for f in red.operands])
                for r, (_, red) in enumerate(program.reductions)]

    def ring_loads(ind: str, core_cell: bool) -> None:
        # each ring's new plane; at a core cell only its far end is checked
        for f, (lo, hi) in rings.items():
            k, c, d = fidx[f], fcls[f], hi + ahead
            if core_cell:   # a ring cell too: it folds against the field's own cell
                val = (f"col{c} && {plus('x', d)} < m{c}x ? "
                       f"{st.widen(f'__ldg({rows[(f, d, 0)]})')} : 0.0f")
            else:
                val = ring_load(f, f"({plus('x', d)})")
            w(f"{ind}r{k}_{d - lo} = {val};  // the ring's new plane")

    def shift(ind: str) -> None:
        for f, (lo, hi) in rings.items():
            k = fidx[f]
            if hi + ahead > lo:
                w(f"{ind}" + " ".join(f"r{k}_{i} = r{k}_{i + 1};" for i in range(hi + ahead - lo)))

    def core_cell(ind: str) -> None:
        # the core program at plane x of a column in the core
        ring_loads(ind, True)
        for j, (f, off) in enumerate(core.loads):
            k = fidx[f]
            d = program.to3(off, 0)
            if f in rings and d[1] == 0 and d[2] == 0:
                src = f"r{k}_{d[0] - rings[f][0]}"
            else:
                src = st.widen(f"__ldg({plus(rows[(f, d[0], d[1])], d[2])})")
                src = f"yz_core ? {src} : 0.0f" if keep else src
            w(f"{ind}const float l{j} = {src};")
        ref = codegen._printer("l", "u", "e")
        codegen._emit_ops(w, ind, core.ops, "e", ref)
        for k, (op, res) in enumerate(zip(program.outputs, core.results)):
            val = codegen.emit_value(w, ind, k, ref(res), st)
            w(f"{ind}" + ("if (yz_core) " if keep else "") + f"*o{k} = {val};")
        if keep and program.reductions:
            folded = {f for _, red in program.reductions for f in red.operands}
            for k, op in enumerate(program.outputs):
                if op.name in folded:   # a ring cell folds the value it keeps
                    w(f"{ind}const float w{k} = yz_core ? v{k} : kin ? "
                      f"{st.widen(f'__ldg(o{k})')} : 0.0f;")
            w(f"{ind}if (kin) {{")
            for line in reds(True):
                w(f"{ind}  {line}")
            w(f"{ind}}}")
            return
        for line in reds(True):
            w(f"{ind}{line}")

    def edge_cell(ind: str) -> None:
        # each output's direct program at plane x: rings and faces
        ring_loads(ind, False)
        w(f"{ind}if (in_grid) {{")
        for c in range(len(classes)):
            w(f"{ind}  const int at{c} = (x - x0) * S{c}x + ty * S{c}y + tz;")
        for k in range(len(program.outputs)):
            w(f"{ind}  float v{k};")
        direct: list[str] = []
        codegen._emit_direct(direct.append, program, fidx, fcls, st=st, in_place=True)
        pad = " " * (len(ind) + 2 - 6)
        for line in direct:
            w(pad + line)
        for line in reds(False):
            w(f"{ind}  {line}")
        w(f"{ind}}}")

    w("  // the planes before the core, the core (no branch a plane), the planes after")
    w("  int x = x0;")
    if keep:
        c = fcls[program.outputs[0].name]
        w("  // every thread runs the core loop: a cell of the (y, z) ring (yz_core")
        w("  // false) keeps its value, a cell past the grid (kin false) does nothing")
        w(f"  const bool kin = y < m{c}y && z < m{c}z;")
        w("  {")
    else:
        w("  if (yz_core) {")
    w("    const int xa = min(max(x0, cxlo), x1), xb = max(min(x1, cxhi), xa);")
    w("    for (; x < xa; ++x) {")
    edge_cell("      ")
    shift("      ")
    w("    }")
    start_rows("    ", "xa")
    w(f"    #pragma unroll {shape.planes}")
    w("    for (; x < xb; ++x) {")
    core_cell("      ")
    advance("      ")
    shift("      ")
    w("    }")
    w("  }")
    w("  for (; x < x1; ++x) {")
    edge_cell("    ")
    shift("    ")
    w("  }")
    codegen.emit_block_fold(w, program)
    w("}")
    w("")
    w("}  // namespace")
    w("")
    codegen._emit_entry(w, program, st, False, batched)
    return "\n".join(lines) + "\n"

