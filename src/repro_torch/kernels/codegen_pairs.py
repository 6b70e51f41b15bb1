"""The pair layout of the generated all-parallel single-step kernel, for
fields stored at 2 bytes (bf16, f16; computed in f32).

:func:`codegen.cuda_source` prints this layout for a
:class:`~codegen.KernelShape` with ``vec`` > 1. It is the one-cell layout
of ``codegen`` laid out again, not another kernel: the same tap program,
the same stages, the same march in steps of ``planes`` planes, the same
core/direct split, the same operations in the same order on every cell.
What changes is what a thread owns: ``vec`` (2 or 4) adjacent cells of the
contiguous z axis instead of one, so that

* every load of the core program and of a stage moves ``vec`` cells of a
  row at once, as one 4-byte (``vec`` 2) or 8-byte (``vec`` 4) word at an
  aligned address, widened by the packed conversion
  (``__bfloat1622float2``, ``__half22float2``). A tap at a z offset the
  word does not start at reads the aligned words that cover it, and each
  cell takes its halves; the words' offsets are shared by the ``vec``
  cells;
* every output is rounded by the packed conversion
  (``__floats2bfloat162_rn``, ``__floats2half2_rn``: each half rounded to
  nearest even, as the one-cell kernel's ``__float2bfloat16_rn``), stored as
  one word, and widened back from the stored halves for the reductions;
* a stage computes ``vec`` adjacent elements per thread (its tile aligned
  to whole words, a word outside the field clamped into it and its elements
  stored as 0), stores them as one ``float2``/``float4`` to shared memory,
  and the core program reads them back as such.

So a warp's load instruction moves 128 (``vec`` 2) or 256 bytes of a row
where the one-cell layout moved 64, and the index arithmetic, conversions
and stores are paid once per word. What bounds the one-cell kernel at 2
bytes on the H100 is not device memory (PERF.md, section 6): it keeps a
third of its bound, as many load instructions in flight as the f32 kernel
with half the bytes in each.

A thread's cells outside the core (faces, rings, a step not wholly inside
the core) go cell by cell through the one-cell kernel's programs, scalar
loads and stores. Reductions keep one accumulator per cell of a thread and
fold them in the one-cell kernel's order (the warp's butterfly over the
cells, then over the block's warps of 32 cells), so a launch with the same
cells per block and chunks equals the one-cell layout's bitwise, sums too.

The layout needs every field's z stride 1, every x and y stride and z
extent a multiple of ``vec``, and every field's address aligned to a word
(:func:`fits`, :func:`aligned_ptrs`); ``kernels/stencil.py`` launches the
one-cell layout where they do not hold.
"""
from __future__ import annotations

from typing import Sequence

from . import codegen
from .codegen import KernelShape, TapProgram

_LANES = "xyzw"


def fits(program: TapProgram, vec: int, extents: Sequence[Sequence[int]],
         strides: Sequence[Sequence[int]]) -> bool:
    """Whether the pair layout of ``vec`` cells a thread serves fields of
    these shape classes: ``extents`` and ``strides`` per class on the
    kernel's (x, y, z). An all-parallel program only (not marched)."""
    if program.layout or vec < 2:
        return False
    return all(e[2] % vec == 0 and s[2] == 1 and s[0] % vec == 0 and s[1] % vec == 0
               for e, s in zip(extents, strides))


def aligned_ptrs(ptrs, vec: int, itemsize: int) -> bool:
    """Whether every address is aligned to a word of ``vec`` cells."""
    return all(p % (vec * itemsize) == 0 for p in ptrs)


def words(offsets, vec: int) -> tuple[int, int]:
    """``(lo, hi)``: the words, in units of ``vec`` cells from a thread's
    first cell, that hold the cells ``v + d`` for each cell ``v`` of the
    thread and each z offset ``d`` of ``offsets``."""
    return (min(d // vec for d in offsets), max((vec - 1 + d) // vec for d in offsets))


def stage_frame(program: TapProgram, s, shape: KernelShape) -> tuple[int, int, int]:
    """``(rows, cols, lo_z)`` of one plane of a stage in shared memory: the
    block's rows and the halo its readers reach, its columns from ``lo_z``
    rounded up to whole words. ``lo_z`` is at or before the halo's start,
    at the residue (modulo ``vec``) whose runs of ``vec`` elements load the
    fewest words (GP's ``re1`` reads most fields at the element's z + 1: its
    runs start one before a word), then the fewest columns."""
    vec = shape.vec
    lo, hi = program.to3(s.lo, 0), program.to3(s.hi, 0)
    taps = [(f, program.to3(off, 0)) for f, off in s.loads]

    def loads(r):
        groups = _word_groups([(f, (dx, dy, dz + r)) for f, (dx, dy, dz) in taps], vec)
        return sum(h - l + 1 for l, h in groups.values())

    best = min(range(vec), key=lambda r: (loads(r), (lo[2] - r) % vec))
    lo_z = lo[2] - (lo[2] - best) % vec
    cols = -(-(shape.tile[0] * vec + hi[2] - lo_z) // vec) * vec
    return shape.tile[1] + hi[1] - lo[1], cols, lo_z


def shared_bytes(program: TapProgram, shape: KernelShape) -> int:
    """Static shared memory of one block: the stages' plane queues and the
    reduction fold's one value per 32 cells and reduction."""
    cells = sum(r * c for r, c, _ in (stage_frame(program, s, shape) for s in program.stages))
    words_ = cells * codegen.queue_planes(program, shape)
    return 4 * (words_ + len(program.reductions) * (shape.threads * shape.vec // 32))


def _vec_type(vec: int) -> str:
    return "float2" if vec == 2 else "float4"


def helpers(st: codegen.Storage, vec: int) -> list[str]:
    """The conversions and the word loads and stores."""
    t, t2 = st.ctype, st.pair
    lines = [f"// fields are stored as {t} and computed in float: a load widens, a store",
             "// rounds to nearest even; kVec adjacent cells of a row move as one word",
             f"__device__ __forceinline__ float widen(const {t} v) {{ return {st.to_float}(v); }}",
             f"__device__ __forceinline__ {t} narrow(const float v) {{ "
             f"return {st.from_float}(v); }}",
             f"__device__ __forceinline__ float2 widen2(const {t2} v) {{ "
             f"return {st.to_float2}(v); }}",
             f"__device__ __forceinline__ {t2} narrow2(const float a, const float b) {{ "
             f"return {st.from_float2}(a, b); }}"]
    if vec == 2:
        lines += [f"__device__ __forceinline__ float2 load_word(const {t}* p) {{",
                  f"  return widen2(*reinterpret_cast<const {t2}*>(p));",
                  "}",
                  f"__device__ __forceinline__ void store_word({t}* p, const {t2} a) {{",
                  f"  *reinterpret_cast<{t2}*>(p) = a;",
                  "}"]
    else:
        lines += [f"struct alignas(8) quad_t {{ {t2} lo, hi; }};  // four cells, 8 bytes",
                  f"__device__ __forceinline__ float4 load_word(const {t}* p) {{",
                  "  const quad_t q = *reinterpret_cast<const quad_t*>(p);",
                  "  const float2 a = widen2(q.lo), b = widen2(q.hi);",
                  "  return make_float4(a.x, a.y, b.x, b.y);",
                  "}",
                  f"__device__ __forceinline__ void store_word({t}* p, const {t2} a, "
                  f"const {t2} b) {{",
                  "  *reinterpret_cast<quad_t*>(p) = quad_t{a, b};",
                  "}"]
    return lines + [""]


def _word_groups(taps, vec: int):
    """``{(key, dx, dy): (lo, hi)}``: the words each row of taps needs
    (``taps``: ``(key, (dx, dy, dz))`` on the kernel's axes)."""
    groups: dict = {}
    for key, (dx, dy, dz) in taps:
        groups.setdefault((key, dx, dy), []).append(dz)
    return {g: words(ds, vec) for g, ds in groups.items()}


def _lane(word: str, half: int) -> str:
    return f"{word}.{_LANES[half]}"


def cuda_source(program: TapProgram, shape: KernelShape, st: codegen.Storage,
                part: str | None = None) -> str:
    """CUDA C++ of the pair layout (module docstring): ``codegen.cuda_source``'s
    entry point and arguments, ``shape.vec`` cells a thread. ``part`` prints
    the timing variants ``codegen.cuda_source`` documents ("load",
    "compute")."""
    vec = shape.vec
    (bz, by), planes = shape.tile, shape.planes
    fidx = {f: k for k, f in enumerate(program.fields)}
    classes = codegen.shape_classes(program)
    fcls = {f: classes.index(program.to3(o, 0)) for f, o in zip(program.fields, program.offsets)}
    n_out, n_red, n_par = len(program.outputs), len(program.reductions), len(program.params)
    core, stages = program.core, program.stages
    lo_x, hi_x = codegen.march_reach(program)
    lead = codegen.march_lag(program, shape)
    frames = [stage_frame(program, s, shape) for s in stages]
    VT = _vec_type(vec)
    T, T2 = st.ctype, st.pair
    dims = ("nx", "ny", "nz")
    strides = codegen.stride_names(program)
    lines: list[str] = []
    w = lines.append
    w("// Generated by repro_torch.kernels.codegen from a traced @parallel update.")
    w("// Replaces the generic Pallas launch src/repro/kernels/stencil.py::")
    w("// build_stencil_call for this update. Pair layout for 2-byte fields: a")
    w(f"// block owns a tile of (y, z) columns, each thread {vec} adjacent cells of z")
    w("// (the contiguous axis) loaded, rounded and stored as one word, and marches")
    w("// a chunk of x planes, kPlanes per step; intermediates read at several")
    w("// shifts are staged once per cell in shared memory, kVec elements a thread.")
    w("// Offsets inside a block are 32-bit, from a 64-bit block base.")
    if part:
        w(f"// Timing variant: {part} only.")
    w("#include <cstdint>")
    w("#include <cuda_runtime.h>")
    for line in st.includes():
        w(line)
    w("")
    w("namespace {")
    for line in helpers(st, vec):
        w(line)
    w(f"constexpr int kBlockZ = {bz};  // threads along z")
    w(f"constexpr int kBlockY = {by};")
    w(f"constexpr int kVec = {vec};  // cells of z a thread owns")
    w("constexpr int kThreads = kBlockZ * kBlockY;")
    w("constexpr int kFoldWarps = kThreads * kVec / 32;  // 32-cell groups a block folds")
    w(f"constexpr int kPlanes = {planes};  // planes per step")
    if stages:
        w(f"constexpr int kSlots = {codegen.queue_planes(program, shape)};  "
          "// planes kept per stage")
        w(f"constexpr int kHi = {hi_x};  // a step stages the planes this far ahead")
        w("")
        w("__device__ __forceinline__ int wrap(int s) {")
        w("  return s < 0 ? s + kSlots : s >= kSlots ? s - kSlots : s;")
        w("}")
    w("")
    w("// max that propagates NaN, as torch.amax does")
    w("__device__ __forceinline__ float max_nan(float a, float b) {")
    w("  return (b != b || b > a) ? b : a;")
    w("}")
    w("")
    params = [f"const {T}* __restrict__ in{k}" for k in range(len(program.fields))]
    params += [f"{T}* __restrict__ out{k}" for k in range(n_out)]
    params += [f"float* __restrict__ part{k}" for k in range(n_red)]
    divs = codegen.divisor_params(program)
    params += [f"const float p{k}" for k in range(n_par)]
    params += [f"const float r{k}" for k in divs]
    params += [f"const int64_t {n}" for n in (*dims, *strides, "xc")]
    w(f"__global__ void __launch_bounds__(kThreads, {shape.min_blocks}) stencil_kernel(")
    w("    " + ",\n    ".join(params) + ") {")
    for k, (s, (py, pz, lz)) in enumerate(zip(stages, frames)):
        w(f"  // stage {k}: footprint {s.footprint}, {codegen.op_count(s.ops)} operations, "
          f"columns from z {lz}")
        w(f"  __shared__ __align__(16) float sm{k}[kSlots][{py * pz}];  // {py} x {pz} per plane")
    w("  const int tz = threadIdx.x, ty = threadIdx.y;")
    w("  const int tid = ty * kBlockZ + tz;")
    w("  const int z0 = blockIdx.x * (kBlockZ * kVec), y0 = blockIdx.y * kBlockY;")
    w("  const int x0 = blockIdx.z * static_cast<int>(xc);")
    w("  const int x1 = min(x0 + static_cast<int>(xc), static_cast<int>(nx));")
    w("  const int y = y0 + ty, zt = z0 + kVec * tz;  // the thread's first cell")
    for c, off in enumerate(classes):
        if any(off):
            w(f"  // shape class {c}: base extents less {off}")
        for ax, n, d in zip("xyz", dims, off):
            w(f"  const int m{c}{ax} = static_cast<int>({n})" + (f" - {d};" if d else ";"))
        codegen._emit_strides(w, c, False)
    for f, k in fidx.items():
        w(f"  const {T}* __restrict__ g{k} = in{k} + b{fcls[f]};")
    for k, op in enumerate(program.outputs):
        w(f"  {T}* __restrict__ h{k} = out{k} + b{fcls[op.name]};")
    codegen._emit_core_box(w, program, fcls)
    w("  const bool in_grid = y < ny && zt < nz;  // all kVec cells, or none")
    w("  const bool y_core = y >= cylo && y < cyhi;")
    w("  const bool yz_core = y_core && zt >= czlo && zt + kVec <= czhi;")
    for k, (s, frame) in enumerate(zip(stages, frames)):
        _emit_stage_setup(w, program, shape, k, s, frame, fcls)
    for r in range(n_red):
        w(f"  float acc{r}[kVec] = {{}};  // one per cell")
    if part:
        w("  float sink = 0.0f;  // what the timing variant drops")
    if stages:
        w("  int base = 0;  // the queue slot of the first plane a step stages")
    first = f"x0{f' - {lead}' if lead else ''}"
    w("  #pragma unroll 1")
    w(f"  for (int xs = {first}; xs < x1; xs += kPlanes) {{")
    for k, (s, frame) in enumerate(zip(stages, frames)):
        _emit_stage(w, program, shape, k, s, frame, fidx, fcls, part == "load")
    if stages:
        w("    __syncthreads();")
    out_idx = {op.name: k for k, op in enumerate(program.outputs)}
    zero = (0,) * program.ndim
    centre = {f: j for j, (f, off) in enumerate(core.loads) if off == zero}

    def operand(f, v, cell_name):
        """A reduction's operand at cell ``v``: an output's rounded value,
        else the field's (a load of the core program where it has one)."""
        if f in out_idx:
            return cell_name(out_idx[f], v)
        if cell_name is _vec_name and f in centre:
            return f"l{v}_{centre[f]}"
        at = f"at{fcls[f]}" + (f" + {v}" if cell_name is _vec_name and v else "")
        return st.widen(f"g{fidx[f]}[{at}]")

    def reds(v, cell_name):
        return [codegen.fold_line(r, red, [operand(f, v, cell_name) for f in red.operands],
                                  acc=f"acc{r}[{v}]")
                for r, (_, red) in enumerate(program.reductions)]

    # ---- the core program at plane x, every cell of the thread
    ind = "      "
    w("    auto core = [&](const int x) {")
    for c in range(len(classes)):
        w(f"{ind}const int at{c} = (x - x0) * S{c}x + ty * S{c}y + (zt - z0);")
    read_planes = sorted({program.to3(rel, 0)[0] for _, rel in core.reads})
    if part != "load":
        for d in read_planes:
            w(f"{ind}const int q{d - lo_x} = wrap(base + (x - xs) + {d - hi_x});")
    taps = [(f, program.to3(off, 0)) for f, off in core.loads]
    groups = _word_groups(taps, vec)
    gname = {}
    for gi, ((f, dx, dy), (wlo, whi)) in enumerate(groups.items()):
        c = fcls[f]
        for wd in range(wlo, whi + 1):
            at = f"at{c}" + (f" + {vec * wd}" if wd > 0 else f" - {-vec * wd}" if wd < 0 else "")
            addr = codegen._offset(at, c, (dx, dy, 0), "S")
            w(f"{ind}const {VT} L{gi}_{wd - wlo} = load_word(g{fidx[f]} + {addr});")
        gname[(f, dx, dy)] = (gi, wlo)
    for j, (f, (dx, dy, dz)) in enumerate(taps):
        gi, wlo = gname[(f, dx, dy)]
        for v in range(vec):
            h = v + dz - vec * wlo
            w(f"{ind}const float l{v}_{j} = {_lane(f'L{gi}_{h // vec}', h % vec)};")
    if part == "load":
        w(f"{ind}sink += " + " + ".join(f"l{v}_{j}" for j in range(len(taps))
                                        for v in range(vec)) + ";")
    else:
        _emit_vec_reads(w, ind, program, shape, frames, vec)
        refs = [codegen._printer(f"l{v}_", f"u{v}_", f"e{v}_") for v in range(vec)]
        for v in range(vec):
            codegen._emit_ops(w, ind, core.ops, f"e{v}_", refs[v])
        for k, (op, res) in enumerate(zip(program.outputs, core.results)):
            vals = [refs[v](res) for v in range(vec)]
            ns = [f"n{k}_{i}" for i in range(vec // 2)]
            for i, n in enumerate(ns):
                w(f"{ind}const {T2} {n} = narrow2({vals[2 * i]}, {vals[2 * i + 1]});")
                w(f"{ind}const float2 w{k}_{i} = widen2({n});")
            for v in range(vec):
                w(f"{ind}const float v{k}_{v} = w{k}_{v // 2}.{_LANES[v % 2]};")
            if part == "compute":
                w(f"{ind}sink += " + " + ".join(f"v{k}_{v}" for v in range(vec)) + ";")
            else:
                w(f"{ind}store_word(h{k} + at{fcls[op.name]}, {', '.join(ns)});")
        for v in range(vec):
            for line in reds(v, _vec_name):
                w(f"{ind}{line}")
    w("    };")
    # ---- one cell of the thread outside the fast path
    w("    // cell v of the thread through the core program, one cell's loads and stores")
    w("    auto core1 = [&](const int x, const int v) {")
    for c in range(len(classes)):
        w(f"{ind}const int at{c} = (x - x0) * S{c}x + ty * S{c}y + (zt - z0) + v;")
    if part != "load":
        for d in read_planes:
            w(f"{ind}const int q{d - lo_x} = wrap(base + (x - xs) + {d - hi_x});")
    for j, (f, off) in enumerate(core.loads):
        c = fcls[f]
        w(f"{ind}const float l{j} = "
          f"{st.widen(f'g{fidx[f]}[{codegen._offset(f"at{c}", c, program.to3(off, 0), "S")}]')};")
    if part == "load":
        w(f"{ind}sink += {' + '.join(f'l{j}' for j in range(len(core.loads)))};")
    else:
        for j, (k, rel) in enumerate(core.reads):
            d, lo = program.to3(rel, 0), program.to3(stages[k].lo, 0)
            py, pz, lz = frames[k]
            w(f"{ind}const float u{j} = sm{k}[q{d[0] - lo_x}][(ty + {d[1] - lo[1]}) * {pz} + "
              f"kVec * tz + v + {d[2] - lz}];")
        ref = codegen._printer("l", "u", "e")
        codegen._emit_ops(w, ind, core.ops, "e", ref)
        for k, (op, res) in enumerate(zip(program.outputs, core.results)):
            val = codegen.emit_value(w, ind, k, ref(res), st)
            if part == "compute":
                w(f"{ind}sink += v{k};")
            else:
                w(f"{ind}h{k}[at{fcls[op.name]}] = {val};")
        for line in reds("v", _one_name):
            w(f"{ind}{line}")
    w("    };")
    w("    // cell v's outputs by their direct programs: rings, faces, the edges of")
    w("    // staggered extents")
    w("    auto direct = [&](const int x, const int v) {")
    w(f"{ind}const int z = zt + v;")
    for c in range(len(classes)):
        w(f"{ind}const int at{c} = (x - x0) * S{c}x + ty * S{c}y + (z - z0);")
    for k in range(n_out):
        w(f"{ind}float v{k};")
    codegen._emit_direct(w, program, fidx, fcls, st=st)
    for line in reds("v", _one_name):
        w(f"{ind}{line}")
    w("    };")
    w("    if (in_grid) {")
    w("      if (yz_core && xs >= x0 && xs >= cxlo && xs + kPlanes <= x1 "
      "&& xs + kPlanes <= cxhi) {")
    w("        #pragma unroll")
    w("        for (int p = 0; p < kPlanes; ++p) core(xs + p);")
    w("      } else {")
    w("        #pragma unroll 1")
    w("        for (int x = max(xs, x0); x < min(xs + kPlanes, x1); ++x) {")
    w("          const bool x_core = y_core && x >= cxlo && x < cxhi;")
    for v in range(vec):
        w(f"          if (x_core && zt + {v} >= czlo && zt + {v} < czhi) core1(x, {v}); "
          f"else direct(x, {v});")
    w("        }")
    w("      }")
    w("    }")
    if stages:
        w("    base = wrap(base + kPlanes);")
    w("  }")
    if part:
        w(f"  if (sink == 1.0e38f) h0[0] = {st.narrow('sink')};")
    if n_red:
        _emit_fold(w, program, vec)
    w("}")
    w("")
    w("}  // namespace")
    w("")
    codegen._emit_entry(w, program, st, False)
    return "\n".join(lines) + "\n"


def _vec_name(k: int, v) -> str:
    return f"v{k}_{v}"


def _one_name(k: int, v) -> str:
    return f"v{k}"


def _emit_vec_reads(w, ind: str, program: TapProgram, shape: KernelShape, frames,
                    vec: int) -> None:
    """The core program's reads of the staged intermediates for every cell
    of the thread, as whole words of ``vec`` floats (``u{v}_{j}``)."""
    lo_x = codegen.march_reach(program)[0]
    core, stages = program.core, program.stages
    VT = _vec_type(vec)
    taps = []
    for k, rel in core.reads:
        d, lo = program.to3(rel, 0), program.to3(stages[k].lo, 0)
        # the read's plane, row and column (from the frame's first) per cell
        taps.append(((k, d[0]), (0, d[1] - lo[1], d[2] - frames[k][2])))
    groups = _word_groups([((key, dy), (0, 0, dz)) for (key, (_, dy, dz)) in taps], vec)
    gname = {}
    for gi, ((key, _, _), (wlo, whi)) in enumerate(groups.items()):
        (k, dx), dy = key
        pz = frames[k][1]
        row = f"sm{k}[q{dx - lo_x}] + (ty + {dy}) * {pz}"
        for wd in range(wlo, whi + 1):
            w(f"{ind}const {VT} U{gi}_{wd - wlo} = reinterpret_cast<const {VT}*>({row})"
              f"[tz{f' + {wd}' if wd else ''}];")
        gname[key] = (gi, wlo)
    for j, ((k, dx), (_, dy, dz)) in enumerate(taps):
        gi, wlo = gname[((k, dx), dy)]
        for v in range(vec):
            h = v + dz - vec * wlo
            w(f"{ind}const float u{v}_{j} = {_lane(f'U{gi}_{h // vec}', h % vec)};")


def _emit_stage_setup(w, program: TapProgram, shape: KernelShape, k: int, s, frame,
                      fcls) -> None:
    """The fixed word-aligned runs of ``vec`` elements each thread stages
    for stage ``k``, every plane: their row clamped into the frame, their
    elements' frame tests, and per shape class and word the offset of the
    word clamped into the field."""
    vec, nt = shape.vec, shape.threads
    py, pz, lz = frame
    r = lz % vec             # a run's first element, from the word it lies in
    lo, trim = program.to3(s.lo, 0), program.to3(s.trim, 0)
    runs = py * (pz // vec)
    per_row = pz // vec
    taps = [(fcls[f], program.to3(off, 0)) for f, off in s.loads]
    wlo, whi = words([d[2] + r for _, d in taps], vec)
    for i in range(-(-runs // nt)):
        e = f"e{k}_{i}"
        w(f"  const int {e} = tid" + (f" + {i * nt};" if i else ";"))
        eyu = f"y0 + {lo[1]} + {e} / {per_row}" if py > 1 else f"y0 + {lo[1]}"
        w(f"  const int ey{k}_{i} = min(max({eyu}, 0), static_cast<int>(ny) - {trim[1] + 1});")
        w(f"  const int wz{k}_{i} = (z0 + {lz - r}) / kVec + {e} % {per_row};  "
          "// the word of its first element")
        for v in range(vec):
            inside = [f"ey{k}_{i} == {eyu}", f"kVec * wz{k}_{i} + {r + v} >= 0",
                      f"kVec * wz{k}_{i} + {r + v} < static_cast<int>(nz) - {trim[2]}"]
            if (i + 1) * nt > runs:
                inside.insert(0, f"{e} < {runs}")
            w(f"  const bool in{k}_{i}_{v} = {' && '.join(inside)};")
        for c in sorted({c for c, _ in taps}):
            for wd in range(wlo, whi + 1):
                word = f"wz{k}_{i}" + (f" + {wd}" if wd > 0 else f" - {-wd}" if wd < 0 else "")
                w(f"  const int o{k}_{i}_{c}_{wd - wlo} = (ey{k}_{i} - y0) * S{c}y + "
                  f"min(max({word}, 0), m{c}z / kVec - 1) * kVec - z0;")


def _emit_stage(w, program: TapProgram, shape: KernelShape, k: int, s, frame, fidx, fcls,
                loads_only: bool) -> None:
    """Stage ``k``'s planes ``xs + kHi .. + kPlanes - 1``, ``vec`` elements
    a thread from whole words; an element outside the frame is stored as 0
    (its word clamped into the field, so every load is in range)."""
    vec, nt = shape.vec, shape.threads
    py, pz, lz = frame
    runs = py * (pz // vec)
    VT = _vec_type(vec)
    trim_x = program.to3(s.trim, 0)[0]
    # each tap from the word of the run's first element
    taps = [(f, (dx, dy, dz + lz % vec)) for f, (dx, dy, dz) in
            ((f, program.to3(off, 0)) for f, off in s.loads)]
    wlo, _ = words([d[2] for _, d in taps], vec)
    groups = _word_groups(taps, vec)
    w(f"    // stage {k}")
    w("    #pragma unroll")
    w("    for (int p = 0; p < kPlanes; ++p) {")
    w("      const int q = xs + kHi + p;")
    w(f"      const int qc = min(max(q, 0), static_cast<int>(nx) - {trim_x + 1});")
    # each plane a tap reads, clamped into its field on its own: a plane
    # read by two of the step's planes at two shifts is then the same load
    # (an element inside the frame reads its taps unclamped either way)
    planes = sorted({(fcls[f], dx) for f, (dx, _, _) in taps})
    for c, dx in planes:
        w(f"      const int xp{c}_{dx} = (min(max(q{f' + {dx}' if dx else ''}, 0), m{c}x - 1) - x0)"
          f" * S{c}x;")
    if not loads_only:
        w(f"      {VT}* const dst = reinterpret_cast<{VT}*>(sm{k}[wrap(base + p)]);")
    for i in range(-(-runs // nt)):
        ind = "        "
        w(f"      if (e{k}_{i} < {runs}) {{" if (i + 1) * nt > runs else "      {")
        gname = {}
        for gi, ((f, dx, dy), (glo, ghi)) in enumerate(groups.items()):
            c = fcls[f]
            for wd in range(glo, ghi + 1):
                at = f"xp{c}_{dx} + o{k}_{i}_{c}_{wd - wlo}"
                addr = codegen._offset(f"({at})", c, (0, dy, 0), "S")
                w(f"{ind}const {VT} A{gi}_{wd - glo} = load_word(g{fidx[f]} + {addr});")
            gname[(f, dx, dy)] = (gi, glo)
        for j, (f, (dx, dy, dz)) in enumerate(taps):
            gi, glo = gname[(f, dx, dy)]
            for v in range(vec):
                h = v + dz - vec * glo
                w(f"{ind}const float a{v}_{j} = {_lane(f'A{gi}_{h // vec}', h % vec)};")
        if loads_only:
            w(f"{ind}sink += " + " + ".join(f"a{v}_{j}" for j in range(len(taps))
                                            for v in range(vec)) + ";")
            w("      }")
            continue
        refs = [codegen._printer(f"a{v}_", "?", f"t{v}_") for v in range(vec)]
        for v in range(vec):
            codegen._emit_ops(w, ind, s.ops, f"t{v}_", refs[v])
        vals = [f"q == qc && in{k}_{i}_{v} ? {refs[v](s.result)} : 0.0f" for v in range(vec)]
        w(f"{ind}dst[e{k}_{i}] = make_{VT}({', '.join(vals)});")
        w("      }")
    w("    }")


def _emit_fold(w, program: TapProgram, vec: int) -> None:
    """Fold each reduction over the block in the one-cell layout's order:
    the butterfly over each 32 cells' lanes (offsets 16 .. ``vec`` across
    threads, then within the thread's cells), then over the 32-cell groups
    in shared memory."""
    n_red = len(program.reductions)
    w("  // Fold each reduction over the block in the one-cell kernel's order: the")
    w("  // butterfly over each 32 cells (across threads, then a thread's cells),")
    w("  // then over the block's 32-cell groups, into the block's own slot of")
    w("  // its partials. No float atomics, so the value is the same on every run.")
    w(f"  __shared__ float red[kFoldWarps * {n_red}];")
    w("  const int lane = tid & 31, warp = tid >> 5;")
    w("  const int64_t bid = (static_cast<int64_t>(blockIdx.z) * gridDim.y + "
      "blockIdx.y) * gridDim.x + blockIdx.x;")
    w("  const int group = tid * kVec / 32;  // the 32-cell group of the thread's cells")
    for r, (_, red) in enumerate(program.reductions):
        comb = red.combine
        w(f"  for (int v = 0; v < kVec; ++v) {{")
        shfl = f"__shfl_xor_sync(0xffffffffu, acc{r}[v], o)"
        w(f"    for (int o = 16 / kVec; o > 0; o >>= 1) "
          f"acc{r}[v] = {codegen._combine(comb, f'acc{r}[v]', shfl)};")
        w("  }")
        o = vec // 2
        while o:
            for v in range(o):
                w(f"  acc{r}[{v}] = {codegen._combine(comb, f'acc{r}[{v}]', f'acc{r}[{v + o}]')};")
            o //= 2
        w(f"  if (tid * kVec % 32 == 0) red[{r} * kFoldWarps + group] = acc{r}[0];")
    w("  __syncthreads();")
    w("  if (warp == 0) {")
    for r, (_, red) in enumerate(program.reductions):
        shfl = f"__shfl_xor_sync(0xffffffffu, a{r}, o)"
        w(f"    float a{r} = lane < kFoldWarps ? red[{r} * kFoldWarps + lane] : 0.0f;")
        comb = codegen._combine(red.combine, f"a{r}", shfl)
        w(f"    for (int o = 16; o > 0; o >>= 1) a{r} = {comb};")
        w(f"    if (lane == 0) part{r}[bid] = a{r};")
    w("  }")
