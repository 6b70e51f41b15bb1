"""Lower a traced :class:`~repro_torch.ir.StencilIR` to a flat tap program
and print it two ways: as CUDA C++ source, and as a torch evaluation over
shifted views.

A tap program holds, for each output, the list of loads it makes relative
to the cell it writes (``(field, (dx, dy, dz))``), a sequence of operations
in single-assignment form over those loads, the scalar parameters and the
literal constants, and the output's write geometry (``inn`` ring or ``all``
per axis). Scalar parameters are the scalar-only subtrees of the update
(``_dx ** 2``, ``lam``): they are evaluated on the host in Python numbers,
as the plain path evaluates them, and reach the kernel as ``float``
arguments. Operand order is kept, so ``1 - x`` and ``x - 1`` lower to
different programs.

The torch form lets the CPU tests check the lowering, which is the hard
part, without ``nvcc``: it must agree bitwise with the ``torch`` backend of
``@parallel``. Only the printing of C syntax is left for the card to check.
"""
from __future__ import annotations

import dataclasses
import math
import struct
from typing import Any, Mapping, Sequence

import torch

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


@dataclasses.dataclass(frozen=True)
class TapProgram:
    """One fused launch: every output's taps, the host-evaluated scalar
    parameters and the reductions folded over the written cells."""

    ndim: int
    fields: tuple[str, ...]
    outputs: tuple[OutputProgram, ...]
    params: tuple[SymScalar, ...]
    reductions: tuple[tuple[str, Reduction], ...]

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


def lower(ir: StencilIR) -> TapProgram:
    """The tap program of a traced update (collocated fields)."""
    params: dict[str, int] = {}
    param_list: list[SymScalar] = []
    outputs = []
    for o in ir.out_names:
        low = _Lowering(ir.write_rings[o], params, param_list)
        result = low.visit(ir.exprs[o], (0,) * ir.ndim)
        outputs.append(OutputProgram(
            name=o, modes=ir.write_modes[o], rings=ir.write_rings[o],
            loads=tuple(low.loads), ops=tuple(low.ops), result=result))
    return TapProgram(ndim=ir.ndim, fields=tuple(ir.field_shapes),
                      outputs=tuple(outputs), params=tuple(param_list),
                      reductions=tuple(ir.reductions.items()))


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

        def view(field, off, rings=op.rings):
            f = fields[field]
            return f[tuple(slice(w + d, n - w + d)
                           for w, d, n in zip(rings, off, f.shape))]

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
        outs[op.name] = out
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
_AXES = ("x", "y", "z")


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
    return f"({args[0]} {_C_BINARY[kind]} {args[1]})"


def _offset(off: tuple[int, ...]) -> str:
    terms = ""
    for d, ax in zip(off, _AXES):
        if d == 1:
            terms += f" + s{ax}"
        elif d == -1:
            terms += f" - s{ax}"
        elif d:
            terms += f" {'+' if d > 0 else '-'} {abs(d)} * s{ax}"
    return f"i{terms}"


def pad3(t: tuple, fill) -> tuple:
    return (fill,) * (3 - len(t)) + tuple(t)


def _combine(kind: str, acc: str, val: str) -> str:
    return f"max_nan({acc}, {val})" if kind == "max" else f"({acc} + {val})"


def cuda_source(program: TapProgram) -> str:
    """CUDA C++ source of the fused launch: one ``__global__`` function and
    a plain C entry point ``launch``. Shapes, strides and the grid are
    runtime arguments, so one build serves every grid size."""
    if program.ndim > 3:
        raise NotImplementedError("the generated CUDA kernel handles 1-3 dimensions")
    fidx = {f: k for k, f in enumerate(program.fields)}
    n_out, n_red, n_par = len(program.outputs), len(program.reductions), len(program.params)
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
    params += [f"const float p{k}" for k in range(n_par)]
    params += [f"const int64_t {n}" for n in ("nx", "ny", "nz", "sx", "sy", "sz", "xc")]
    w("__global__ void __launch_bounds__(kBlockZ * kBlockY) stencil_kernel(")
    w("    " + ",\n    ".join(params) + ") {")
    w("  const int64_t z = static_cast<int64_t>(blockIdx.x) * kBlockZ + threadIdx.x;")
    w("  const int64_t y = static_cast<int64_t>(blockIdx.y) * kBlockY + threadIdx.y;")
    w("  const int64_t x0 = static_cast<int64_t>(blockIdx.z) * xc;")
    w("  const int64_t x1 = x0 + xc < nx ? x0 + xc : nx;")
    for r in range(n_red):
        w(f"  float acc{r} = 0.0f;")
    w("  if (z < nz && y < ny) {")
    if n_red:
        # Unrolled, a loop that carries reduction accumulators took 79
        # registers (3 blocks of 256 threads per SM) and ran slower than
        # rolled (63); without accumulators the unrolled loop takes 32.
        w("    #pragma unroll 1")
    w("    for (int64_t x = x0; x < x1; ++x) {")
    w("      const int64_t i = x * sx + y * sy + z * sz;")
    for k, op in enumerate(program.outputs):
        modes, rings = pad3(op.modes, "all"), pad3(op.rings, 0)
        conds = [f"{ax} >= {r} && {ax} < n{ax} - {r}"
                 for ax, m, r in zip(_AXES, modes, rings) if m == "inn" and r]
        w(f"      float v{k};  // output {op.name}")
        w(f"      if ({' && '.join(conds) if conds else 'true'}) {{")
        for j, (f, off) in enumerate(op.loads):
            w(f"        const float l{j} = in{fidx[f]}[{_offset(pad3(off, 0))}];")

        def ref(r):
            kind, v = r
            if kind == "load":
                return f"l{v}"
            if kind == "op":
                return f"e{v}"
            if kind == "param":
                return f"p{v}"
            return float_literal(v)

        for j, (kind, args) in enumerate(op.ops):
            w(f"        const float e{j} = "
              f"{_c_expr(kind, [ref(a) for a in args], list(args))};")
        w(f"        v{k} = {ref(op.result)};")
        w("      } else {")
        w(f"        v{k} = in{fidx[op.name]}[i];")
        w("      }")
        w(f"      out{k}[i] = v{k};")
    out_idx = {op.name: k for k, op in enumerate(program.outputs)}
    for r, (_, red) in enumerate(program.reductions):
        vals = [f"v{out_idx[f]}" if f in out_idx else f"in{fidx[f]}[i]"
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
    cargs += [f"float p{k}" for k in range(n_par)]
    cargs += [f"int64_t {n}" for n in ("nx", "ny", "nz", "sx", "sy", "sz", "xc",
                                       "gz", "gy", "gx")]
    cargs += ["void* stream"]
    w('extern "C" int launch(' + ", ".join(cargs) + ") {")
    w("  const dim3 grid(static_cast<unsigned>(gz), static_cast<unsigned>(gy), "
      "static_cast<unsigned>(gx));")
    w("  const dim3 block(kBlockZ, kBlockY, 1);")
    kargs = [f"static_cast<const float*>(in{k})" for k in range(len(program.fields))]
    kargs += [f"static_cast<float*>(out{k})" for k in range(n_out)]
    kargs += [f"static_cast<float*>(part{k})" for k in range(n_red)]
    kargs += [f"p{k}" for k in range(n_par)]
    kargs += ["nx", "ny", "nz", "sx", "sy", "sz", "xc"]
    w("  stencil_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(")
    w("      " + ", ".join(kargs) + ");")
    w("  return static_cast<int>(cudaGetLastError());")
    w("}")
    w("")
    w('extern "C" const char* error_string(int err) {')
    w("  return cudaGetErrorString(static_cast<cudaError_t>(err));")
    w("}")
    return "\n".join(lines) + "\n"
