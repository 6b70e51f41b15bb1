"""Lower a traced :class:`~repro_torch.ir.StencilIR` to a flat tap program
and print it two ways: as CUDA C++ source, and as a torch evaluation over
shifted views.

A tap program holds, for each output, the list of loads it makes relative
to the cell it writes (``(field, (dx, dy, dz))``), a sequence of operations
in single-assignment form over those loads, the scalar parameters and the
literal constants, the output's write geometry (``inn`` ring or ``all``
per axis) and its boundary condition. Loads are relative to the output cell
in every field's own index space (a face-centred field's cell ``c`` sits
beside the base cell ``c``), as the reference's relative-slice protocol
reads them. Scalar parameters are the scalar-only subtrees of the update
(``_dx ** 2``, ``lam``): they are evaluated on the host in Python numbers,
as the plain path evaluates them, and reach the kernel as ``float``
arguments. Operand order is kept, so ``1 - x`` and ``x - 1`` lower to
different programs.

The torch form lets the CPU tests check the lowering, which is the hard
part, without ``nvcc``: it must agree bitwise with the ``torch`` backend of
``@parallel``. It realizes boundary conditions as the kernel does, by
taking each face cell's value from its source cell (:func:`bc_source`),
not by the post-pass it is held against. Only the printing of C syntax is
left for the card to check.
"""
from __future__ import annotations

import dataclasses
import math
import struct
from typing import Any, Mapping, Sequence

import torch

from ..ir.bc import BoundaryCondition
from ..ir.reductions import Reduction
from ..ir.sym import BINARY_OPS, UNARY_OPS, SymScalar
from ..ir.trace import StencilIR

# An operand of an operation: ("load", i), ("op", i), ("param", i) or
# ("const", number).
Ref = tuple[str, Any]


@dataclasses.dataclass(frozen=True)
class OutputProgram:
    """The taps and operations that compute one output."""

    name: str
    modes: tuple[str, ...]
    rings: tuple[int, ...]
    loads: tuple[tuple[str, tuple[int, ...]], ...]
    ops: tuple[tuple[str, tuple[Ref, ...]], ...]
    result: Ref
    bc: BoundaryCondition | None = None


@dataclasses.dataclass(frozen=True)
class TapProgram:
    """One fused launch: every output's taps, the host-evaluated scalar
    parameters and the reductions folded over the written cells."""

    ndim: int
    fields: tuple[str, ...]
    outputs: tuple[OutputProgram, ...]
    params: tuple[SymScalar, ...]
    reductions: tuple[tuple[str, Reduction], ...]
    offsets: tuple[tuple[int, ...], ...] = ()   # per field: base shape - field shape

    def host_values(self, scalars: Mapping[str, Any]) -> list:
        """The scalar parameters' values for one call."""
        return [p.evaluate(scalars) for p in self.params]


class _Lowering:
    def __init__(self, rings: tuple[int, ...], params: dict[str, int],
                 param_list: list[SymScalar]):
        self.rings = rings
        self.params = params
        self.param_list = param_list
        self.loads: dict[tuple[str, tuple[int, ...]], int] = {}
        self.ops: dict[tuple[str, tuple[Ref, ...]], int] = {}
        self.memo: dict[tuple[int, tuple[int, ...]], Ref] = {}

    def scalar(self, s: SymScalar) -> Ref:
        if s.is_const:
            return ("const", s.value)
        key = s.key()
        if key not in self.params:
            self.params[key] = len(self.param_list)
            self.param_list.append(s)
        return ("param", self.params[key])

    def emit(self, kind: str, args: tuple[Ref, ...]) -> Ref:
        key = (kind, args)
        if key not in self.ops:
            self.ops[key] = len(self.ops)
        return ("op", self.ops[key])

    def visit(self, node, shift: tuple[int, ...]) -> Ref:
        if isinstance(node, SymScalar):
            return self.scalar(node)
        memo_key = (id(node), shift)
        if memo_key in self.memo:
            return self.memo[memo_key]
        if node.op == "leaf":
            off = tuple(s - w for s, w in zip(shift, self.rings))
            key = (node.name, off)
            if key not in self.loads:
                self.loads[key] = len(self.loads)
            ref = ("load", self.loads[key])
        elif node.op == "slice":
            ref = self.visit(node.children[0],
                             tuple(s + st for s, st in zip(shift, node.starts)))
        else:
            ref = self.emit(node.op, tuple(self.visit(c, shift) for c in node.children))
        self.memo[memo_key] = ref
        return ref


def lower(ir: StencilIR, bcs: Mapping[str, BoundaryCondition] | None = None) -> TapProgram:
    """The tap program of a traced update, with each output's boundary
    condition (``bcs``, normalized)."""
    bcs = dict(bcs or {})
    params: dict[str, int] = {}
    param_list: list[SymScalar] = []
    outputs = []
    for o in ir.out_names:
        low = _Lowering(ir.write_rings[o], params, param_list)
        result = low.visit(ir.exprs[o], (0,) * ir.ndim)
        outputs.append(OutputProgram(
            name=o, modes=ir.write_modes[o], rings=ir.write_rings[o],
            loads=tuple(low.loads), ops=tuple(low.ops), result=result,
            bc=bcs.get(o)))
    return TapProgram(ndim=ir.ndim, fields=tuple(ir.field_shapes),
                      outputs=tuple(outputs), params=tuple(param_list),
                      reductions=tuple(ir.reductions.items()),
                      offsets=tuple(ir.offsets[f] for f in ir.field_shapes))


# ---------------------------------------------------------- boundary sources
def bc_source(kind: str, n: int, depth: int) -> list[int]:
    """Per cell of an axis of extent ``n``, the cell whose post-write value
    a ``neumann0`` or ``periodic`` face takes (``core.boundary``'s low then
    high face; interior cells map to themselves). ``check_depth`` keeps
    every source off both faces, so mapping each axis on its own gives the
    post-pass's corners too. The CUDA form prints the same arithmetic."""
    d = depth
    shift = d if kind == "neumann0" else n - 2 * d
    return [g + shift if g < d else g - shift if g >= n - d else g for g in range(n)]


def apply_bc(out: torch.Tensor, bc: BoundaryCondition) -> torch.Tensor:
    """``out`` with ``bc`` realized as the kernel realizes it: a dirichlet
    face holds the value, any other face the value of its source cell."""
    axes = sorted(set(bc.resolved_axes(out.dim())))
    d = bc.depth
    if bc.kind == "dirichlet":
        face = torch.zeros(out.shape, dtype=torch.bool, device=out.device)
        for a in axes:
            g = torch.arange(out.shape[a], device=out.device).view(
                [-1 if b == a else 1 for b in range(out.dim())])
            face = face | (g < d) | (g >= out.shape[a] - d)
        return torch.where(face, torch.tensor(bc.value, dtype=out.dtype, device=out.device),
                           out)
    for a in axes:
        src = torch.tensor(bc_source(bc.kind, out.shape[a], d), device=out.device)
        out = out.index_select(a, src)
    return out


# ---------------------------------------------------------------- torch form
def _apply(kind: str, args: Sequence):
    if kind in UNARY_OPS:
        return UNARY_OPS[kind](args[0])
    return BINARY_OPS[kind](*args)


def evaluate_torch(program: TapProgram, fields: Mapping[str, torch.Tensor],
                   scalars: Mapping[str, Any]):
    """Run the tap program with torch operators on shifted views of
    ``fields``. Returns ``(outputs, reductions)``; ``reductions`` is None
    when the program has none."""
    host = program.host_values(scalars)
    outs = {}
    for op in program.outputs:
        prev = fields[op.name]
        region = tuple(slice(w, n - w) for w, n in zip(op.rings, prev.shape))

        def view(field, off, rings=op.rings, shape=prev.shape):
            # the output's region, shifted by the tap, in the field's own
            # index space
            return fields[field][tuple(slice(w + d, n - w + d)
                                       for w, d, n in zip(rings, off, shape))]

        loads = [view(f, off) for f, off in op.loads]
        vals: list = []

        def resolve(ref):
            kind, v = ref
            if kind == "load":
                return loads[v]
            if kind == "op":
                return vals[v]
            if kind == "param":
                return host[v]
            return v

        for kind, args in op.ops:
            vals.append(_apply(kind, [resolve(a) for a in args]))
        out = prev.clone()
        out[region] = resolve(op.result)
        outs[op.name] = out if op.bc is None else apply_bc(out, op.bc)
    if not program.reductions:
        return outs, None
    reds = {}
    for name, r in program.reductions:
        ops = [outs[f] if f in outs else fields[f] for f in r.operands]
        reds[name] = r.fold(r.map_element(*ops))
    return outs, reds


# ----------------------------------------------------------------- CUDA form
BLOCK_Z, BLOCK_Y = 32, 8


def float_literal(v) -> str:
    """The f32 value of a Python number, exactly, as a C++ literal: the
    number is rounded to f32 as PyTorch rounds a Python scalar, and printed
    in hexadecimal so no decimal rounding intervenes."""
    (f,) = struct.unpack("f", struct.pack("f", float(v)))
    if math.isfinite(f):
        return f"{f.hex()}f"
    (bits,) = struct.unpack("I", struct.pack("f", f))
    return f"__int_as_float(0x{bits:08x})"


_C_BINARY = {"add": "+", "sub": "-", "mul": "*", "div": "/"}


def reciprocal(v) -> float:
    """The reciprocal of a scalar divisor as PyTorch forms it for its CUDA
    division: 1 / s in double, to be rounded once to f32 (found on the H100
    with PyTorch 2.11: ``x / s`` equals ``x * float32(1 / s)`` there, not
    ``x * (1 / float32(s))``, for s = 10/23 and 10/8191)."""
    v = float(v)
    return 1.0 / v if v else math.copysign(math.inf, v)


def divisor_params(program: TapProgram) -> tuple[int, ...]:
    """The scalar parameters that divide a tensor: the launch passes each
    one's :func:`reciprocal` as well, after the parameters."""
    return tuple(sorted({args[1][1] for op in program.outputs for kind, args in op.ops
                         if kind == "div" and args[1][0] == "param"
                         and args[0][0] in ("load", "op")}))


def _recip(ref: Ref) -> str:
    if ref[0] == "const":
        return float_literal(reciprocal(ref[1]))
    return f"r{ref[1]}"


def _c_expr(kind: str, args: list[str], raw: list[Ref]) -> str:
    if kind == "neg":
        return f"(-{args[0]})"
    if kind == "abs":
        return f"fabsf({args[0]})"
    if kind == "pow":
        # PyTorch computes x ** 2 and x ** 3 as products and x ** 0.5 as a
        # square root; other exponents go through powf, which is not
        # bitwise against the CPU (PERF.md states the bound).
        if raw[1][0] == "const" and raw[1][1] in (2, 3):
            return "(" + " * ".join([args[0]] * int(raw[1][1])) + ")"
        if raw[1][0] == "const" and raw[1][1] == 0.5:
            return f"sqrtf({args[0]})"
        return f"powf({args[0]}, {args[1]})"
    if kind == "div":
        scalar = [r[0] in ("param", "const") for r in raw]
        if scalar[1] and not scalar[0]:
            # PyTorch's CUDA division of a tensor by a host scalar multiplies
            # by the scalar's f32 reciprocal (div_true_kernel_cuda)
            return f"({args[0]} * {_recip(raw[1])})"
        if scalar[0] and not scalar[1]:
            # a scalar over a tensor is Tensor.__rtruediv__:
            # reciprocal(tensor) * scalar
            return f"((1.0f / {args[1]}) * {args[0]})"
    return f"({args[0]} {_C_BINARY[kind]} {args[1]})"


def pad3(t: tuple, fill) -> tuple:
    return (fill,) * (3 - len(t)) + tuple(t)


def _combine(kind: str, acc: str, val: str) -> str:
    return f"max_nan({acc}, {val})" if kind == "max" else f"({acc} + {val})"


def shape_classes(program: TapProgram) -> tuple[tuple[int, int, int], ...]:
    """The distinct staggering offsets of the program's fields, padded to
    3-D: fields of one class share extents and strides, and the launch
    passes one pair of strides per class."""
    return tuple(sorted({pad3(o, 0) for o in program.offsets}))


def _index(coords: Sequence[str], c: int) -> str:
    """The flat index of the cell at ``coords`` in a field of class ``c``
    (z is contiguous)."""
    return f"{coords[0]} * s{c}x + {coords[1]} * s{c}y + {coords[2]}"


def _offset(base: str, c: int, off: tuple[int, ...]) -> str:
    """``base`` moved by the tap ``off`` in a field of class ``c``."""
    terms = ""
    for d, s in zip(off, (f"s{c}x", f"s{c}y", "")):
        if not d:
            continue
        term = f"{abs(d)} * {s}" if s and abs(d) != 1 else (s or str(abs(d)))
        terms += f" {'+' if d > 0 else '-'} {term}"
    return f"{base}{terms}"


def cuda_source(program: TapProgram) -> str:
    """CUDA C++ source of the fused launch: one ``__global__`` function and
    a plain C entry point ``launch``. The base extents, one pair of strides
    per shape class and the grid are runtime arguments, so one build serves
    every grid size; the staggering offsets are fixed by the program.

    The launch covers the base (cell-centred) extent. Each output is written
    inside its own extent only (a face-centred output is shorter), with its
    update inside its write region and its previous value on the ring. A
    boundary condition is computed in the same launch: a dirichlet face
    holds its value, and a neumann0 or periodic face evaluates the output at
    its source cell (:func:`bc_source`), with the same expression in the
    same order, so it equals that cell's own value bitwise. Reductions fold
    every output after its boundary condition."""
    if program.ndim > 3:
        raise NotImplementedError("the generated CUDA kernel handles 1-3 dimensions")
    lead = 3 - program.ndim
    fidx = {f: k for k, f in enumerate(program.fields)}
    classes = shape_classes(program)
    fcls = {f: classes.index(pad3(o, 0)) for f, o in zip(program.fields, program.offsets)}
    n_out, n_red, n_par = len(program.outputs), len(program.reductions), len(program.params)
    dims = ("nx", "ny", "nz")
    strides = [f"s{c}{ax}" for c in range(len(classes)) for ax in ("x", "y")]
    lines = []
    w = lines.append
    w("// Generated by repro_torch.kernels.codegen from a traced @parallel update.")
    w("// Replaces the generic Pallas launch src/repro/kernels/stencil.py::")
    w("// build_stencil_call for this update. Each thread marches a column")
    w("// segment along x; threadIdx.x runs along z, the contiguous axis.")
    w("#include <cstdint>")
    w("#include <cuda_runtime.h>")
    w("")
    w("namespace {")
    w(f"constexpr int kBlockZ = {BLOCK_Z};")
    w(f"constexpr int kBlockY = {BLOCK_Y};")
    w("")
    w("// max that propagates NaN, as torch.amax does")
    w("__device__ __forceinline__ float max_nan(float a, float b) {")
    w("  return (b != b || b > a) ? b : a;")
    w("}")
    w("")
    params = [f"const float* __restrict__ in{k}" for k in range(len(program.fields))]
    params += [f"float* __restrict__ out{k}" for k in range(n_out)]
    params += [f"float* __restrict__ part{k}" for k in range(n_red)]
    divs = divisor_params(program)
    params += [f"const float p{k}" for k in range(n_par)]
    params += [f"const float r{k}" for k in divs]
    params += [f"const int64_t {n}" for n in (*dims, *strides, "xc")]
    w("__global__ void __launch_bounds__(kBlockZ * kBlockY) stencil_kernel(")
    w("    " + ",\n    ".join(params) + ") {")
    w("  const int64_t z = static_cast<int64_t>(blockIdx.x) * kBlockZ + threadIdx.x;")
    w("  const int64_t y = static_cast<int64_t>(blockIdx.y) * kBlockY + threadIdx.y;")
    w("  const int64_t x0 = static_cast<int64_t>(blockIdx.z) * xc;")
    w("  const int64_t x1 = x0 + xc < nx ? x0 + xc : nx;")
    for c, off in enumerate(classes):
        if any(off):
            w(f"  // shape class {c}: base extents less {off}")
        for ax, n, d in zip("xyz", dims, off):
            w(f"  const int64_t m{c}{ax} = {n}" + (f" - {d};" if d else ";"))
    for r in range(n_red):
        w(f"  float acc{r} = 0.0f;")
    w("  if (z < nz && y < ny) {")
    if n_red:
        # Unrolled, a loop that carries reduction accumulators took 79
        # registers (3 blocks of 256 threads per SM) and ran slower than
        # rolled (63); without accumulators the unrolled loop takes 32.
        w("    #pragma unroll 1")
    w("    for (int64_t x = x0; x < x1; ++x) {")
    for c in range(len(classes)):
        w(f"      const int64_t i{c} = {_index(('x', 'y', 'z'), c)};")

    def ref(r):
        kind, v = r
        if kind == "load":
            return f"l{v}"
        if kind == "op":
            return f"e{v}"
        if kind == "param":
            return f"p{v}"
        return float_literal(v)

    for k, op in enumerate(program.outputs):
        co = fcls[op.name]
        modes, rings = pad3(op.modes, "all"), pad3(op.rings, 0)
        bc = op.bc
        bc_axes = sorted({a + lead for a in bc.resolved_axes(program.ndim)}) if bc else []
        mapped = bc is not None and bc.kind != "dirichlet"
        coords = tuple(f"{ax}{k}" for ax in "XYZ") if mapped else ("x", "y", "z")
        w(f"      float v{k};  // output {op.name}" + (f", bc {bc.kind}" if bc else ""))
        staggered = any(pad3(program.offsets[fidx[op.name]], 0))
        ind = "      "
        if staggered:
            w(f"      if (x < m{co}x && y < m{co}y && z < m{co}z) {{  // its own extent")
            ind += "  "
        w(f"{ind}{{")
        body = ind + "  "
        if mapped:
            # the source cell, axis by axis (neumann0: one face depth
            # inward; periodic: across the domain)
            for ax, X in zip("xyz", coords):
                w(f"{body}int64_t {X} = {ax.lower()};")
            for a in bc_axes:
                X, m, d = coords[a], f"m{co}{'xyz'[a]}", bc.depth
                shift = f"{d}" if bc.kind == "neumann0" else f"({m} - {2 * d})"
                w(f"{body}if ({X} < {d}) {X} += {shift}; "
                  f"else if ({X} >= {m} - {d}) {X} -= {shift};")
            used = sorted({fcls[f] for f, _ in op.loads} | {co})
            for c in used:
                w(f"{body}const int64_t j{k}_{c} = {_index(coords, c)};")
        base = (lambda c: f"j{k}_{c}") if mapped else (lambda c: f"i{c}")
        conds = [f"{X} >= {r} && {X} < m{co}{ax} - {r}"
                 for X, ax, m, r in zip(coords, "xyz", modes, rings) if m == "inn" and r]
        if bc is not None and bc.kind == "dirichlet":
            faces = [f"{X} < {bc.depth} || {X} >= m{co}{'xyz'[a]} - {bc.depth}"
                     for a in bc_axes for X in [coords[a]]]
            w(f"{body}if ({' || '.join(faces)}) {{")
            w(f"{body}  v{k} = {float_literal(bc.value)};")
            w(f"{body}}} else if ({' && '.join(conds) if conds else 'true'}) {{")
        else:
            w(f"{body}if ({' && '.join(conds) if conds else 'true'}) {{")
        inner = body + "  "
        for j, (f, off) in enumerate(op.loads):
            c = fcls[f]
            w(f"{inner}const float l{j} = in{fidx[f]}[{_offset(base(c), c, pad3(off, 0))}];")
        for j, (kind, args) in enumerate(op.ops):
            w(f"{inner}const float e{j} = "
              f"{_c_expr(kind, [ref(a) for a in args], list(args))};")
        w(f"{inner}v{k} = {ref(op.result)};")
        w(f"{body}}} else {{")
        w(f"{inner}v{k} = in{fidx[op.name]}[{base(co)}];")
        w(f"{body}}}")
        w(f"{ind}}}")
        w(f"{ind}out{k}[i{co}] = v{k};")
        if staggered:
            w("      }")
    out_idx = {op.name: k for k, op in enumerate(program.outputs)}
    for r, (_, red) in enumerate(program.reductions):
        vals = [f"v{out_idx[f]}" if f in out_idx else f"in{fidx[f]}[i{fcls[f]}]"
                for f in red.operands]
        if red.kind == "max_abs":
            m = f"fabsf({vals[0]})"
        elif red.kind == "max_abs_diff":
            m = f"fabsf({vals[0]} - {vals[1]})"
        elif red.kind == "sum":
            m = vals[0]
        elif red.kind == "sum_sq":
            m = f"{vals[0]} * {vals[0]}"
        else:
            raise NotImplementedError(
                f"reduction kind {red.kind!r} is not ported to the CUDA kernel")
        w(f"      acc{r} = {_combine(red.combine, f'acc{r}', f'({m})')};")
    w("    }")
    w("  }")
    if n_red:
        w("  // Fold each reduction over the block in shared memory into the")
        w("  // block's own slot of its partials: no float atomics, so the")
        w("  // value is the same on every run.")
        w("  __shared__ float red[kBlockZ * kBlockY];")
        w("  const int tid = threadIdx.y * kBlockZ + threadIdx.x;")
        w("  const int64_t bid = (static_cast<int64_t>(blockIdx.z) * gridDim.y + "
          "blockIdx.y) * gridDim.x + blockIdx.x;")
        for r, (_, red) in enumerate(program.reductions):
            w(f"  red[tid] = acc{r};")
            w("  __syncthreads();")
            w("  for (int s = kBlockZ * kBlockY / 2; s > 0; s >>= 1) {")
            w(f"    if (tid < s) red[tid] = {_combine(red.combine, 'red[tid]', 'red[tid + s]')};")
            w("    __syncthreads();")
            w("  }")
            w(f"  if (tid == 0) part{r}[bid] = red[0];")
            w("  __syncthreads();")
    w("}")
    w("")
    w("}  // namespace")
    w("")
    cargs = [f"const void* in{k}" for k in range(len(program.fields))]
    cargs += [f"void* out{k}" for k in range(n_out)]
    cargs += [f"void* part{k}" for k in range(n_red)]
    cargs += [f"float p{k}" for k in range(n_par)] + [f"float r{k}" for k in divs]
    cargs += [f"int64_t {n}" for n in (*dims, *strides, "xc", "gz", "gy", "gx")]
    cargs += ["void* stream"]
    w('extern "C" int launch(' + ", ".join(cargs) + ") {")
    w("  const dim3 grid(static_cast<unsigned>(gz), static_cast<unsigned>(gy), "
      "static_cast<unsigned>(gx));")
    w("  const dim3 block(kBlockZ, kBlockY, 1);")
    kargs = [f"static_cast<const float*>(in{k})" for k in range(len(program.fields))]
    kargs += [f"static_cast<float*>(out{k})" for k in range(n_out)]
    kargs += [f"static_cast<float*>(part{k})" for k in range(n_red)]
    kargs += [f"p{k}" for k in range(n_par)] + [f"r{k}" for k in divs]
    kargs += [*dims, *strides, "xc"]
    w("  stencil_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(")
    w("      " + ", ".join(kargs) + ");")
    w("  return static_cast<int>(cudaGetLastError());")
    w("}")
    w("")
    w('extern "C" const char* error_string(int err) {')
    w("  return cudaGetErrorString(static_cast<cudaError_t>(err));")
    w("}")
    return "\n".join(lines) + "\n"
