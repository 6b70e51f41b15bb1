"""Lower a traced :class:`~repro_torch.ir.StencilIR` to a tap program and
print it two ways: as CUDA C++ source, and as a torch evaluation over
shifted views.

A tap program holds three kinds of straight-line program, each a list of
loads relative to the cell it computes (``(field, (dx, dy, dz))``) and a
sequence of operations in single-assignment form over them:

* the **core** program (:class:`CoreProgram`): every output of the update
  at one cell, in one shared sequence. Outputs that read the same value at
  the same shift share its loads and operations (porosity's ``phi2`` reuses
  ``Pe2``'s update). It serves every cell where all outputs are written by
  their update and no boundary face lies;
* the **stages** (:class:`Stage`): intermediates of the update that the
  core program reads at more than one shift (GP's new ``re1`` at seven,
  porosity's face fluxes ``qx`` and ``qy`` at two each). Each is computed
  once per element by its own program and read by the core program at its
  shifts (``("read", i)`` operands): the CUDA kernel stages it in shared
  memory, the torch form as a whole tensor, as the ``torch`` backend and the
  reference's window-wise Pallas body compute it;
* each output's **direct** program (:class:`OutputProgram`): its update
  expanded alone, with nothing staged, for the cells outside the core:
  kept rings, the cells of a staggered output's extent that another output
  does not cover, and boundary faces, where a ``neumann0`` or ``periodic``
  cell evaluates its output at its source cell (:func:`bc_source`).

Loads are relative to the computed cell in every field's own index space (a
face-centred field's cell ``c`` sits beside the base cell ``c``), as the
reference's relative-slice protocol reads them; an intermediate's element
``e`` sits in the same integer coordinates. Scalar parameters are the
scalar-only subtrees of the update (``_dx ** 2``, ``lam``): they are
evaluated on the host in Python numbers, as the plain path evaluates them,
and reach the kernel as ``float`` arguments. Operand order is kept, so
``1 - x`` and ``x - 1`` lower to different programs. Every value is computed
by the same operations in the same order on every path, so the core, staged
and direct values of a cell are bitwise the same.

Fields may be stored narrower than they are computed (:class:`Storage`):
a bf16 or f16 kernel widens every load to f32, runs the same program in f32
and rounds each output to its storage type on store (round to nearest
even); reductions fold the stored value, widened to f32. The torch form
does the same on tensors. At 2 bytes the programs of :data:`PAIRS` print
the pair layout of ``kernels/codegen_pairs.py`` (several adjacent cells of
the contiguous axis a thread, moved as one word), the same program laid
out again.

The torch form lets the CPU tests check the lowering, which is the hard
part, without ``nvcc``: it must agree bitwise with the ``torch`` backend of
``@parallel``. It realizes boundary conditions as the kernel does, by
taking each face cell's value from its source cell, not by the post-pass it
is held against. Only the printing of C syntax is left for the card to
check.
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
from .ref import stored_value

# An operand of an operation: ("load", i), ("read", i) (a staged
# intermediate), ("op", i), ("param", i) or ("const", number).
Ref = tuple[str, Any]
Loads = tuple[tuple[str, tuple[int, ...]], ...]
Ops = tuple[tuple[str, tuple[Ref, ...]], ...]

# An intermediate is staged when reading it at its extra shifts, instead of
# computing it again there, saves at least this many operations per cell:
# below that, the shared-memory round trip and the barrier cost more than
# they save (porosity's flux kernel recomputes k = (phi / phi0) ** 3).
STAGE_MIN_SAVED_OPS = 8


@dataclasses.dataclass(frozen=True)
class Storage:
    """How a kernel's fields are stored: the C++ type of a storage dtype
    and the intrinsics that widen it to f32 on load and round f32 to it on
    store (to nearest even, NaN kept quiet). f32 storage prints neither:
    its loads and stores are plain."""

    dtype: torch.dtype
    ctype: str = "float"
    header: str = ""
    to_float: str = ""
    from_float: str = ""
    # two adjacent cells as one word, and its packed conversions (the pair
    # layout, ``kernels/codegen_pairs.py``)
    pair: str = ""
    to_float2: str = ""
    from_float2: str = ""

    @property
    def wide(self) -> bool:
        return self.dtype == torch.float32

    @property
    def itemsize(self) -> int:
        return torch.finfo(self.dtype).bits // 8

    def widen(self, e: str) -> str:
        return e if self.wide else f"widen({e})"

    def narrow(self, e: str) -> str:
        return e if self.wide else f"narrow({e})"

    def rounded(self, e: str) -> str:
        """``e`` rounded to the storage type and widened back: the value a
        store keeps, the one a reduction folds."""
        return e if self.wide else f"widen(narrow({e}))"

    def includes(self) -> list[str]:
        return [] if self.wide else [f"#include <{self.header}>"]

    def helpers(self) -> list[str]:
        """The conversions' device functions (none for f32)."""
        if self.wide:
            return []
        t = self.ctype
        return [f"// fields are stored as {t} and computed in float: a load widens,",
                "// a store rounds to nearest even",
                f"__device__ __forceinline__ float widen(const {t} v) {{ return {self.to_float}(v); }}",
                f"__device__ __forceinline__ {t} narrow(const float v) {{ "
                f"return {self.from_float}(v); }}",
                ""]


_STORAGES = {
    torch.float32: Storage(torch.float32),
    torch.bfloat16: Storage(torch.bfloat16, "__nv_bfloat16", "cuda_bf16.h", "__bfloat162float",
                            "__float2bfloat16_rn", "__nv_bfloat162", "__bfloat1622float2",
                            "__floats2bfloat162_rn"),
    torch.float16: Storage(torch.float16, "__half", "cuda_fp16.h", "__half2float",
                           "__float2half_rn", "__half2", "__half22float2", "__floats2half2_rn"),
}


def storage(dtype: torch.dtype = torch.float32) -> Storage:
    """The :class:`Storage` of a storage dtype (f32, bf16 or f16)."""
    if dtype not in _STORAGES:
        raise NotImplementedError(f"storage dtype {dtype} is not ported to the CUDA kernel")
    return _STORAGES[dtype]


@dataclasses.dataclass(frozen=True)
class OutputProgram:
    """The taps and operations that compute one output on its own."""

    name: str
    modes: tuple[str, ...]
    rings: tuple[int, ...]
    loads: Loads
    ops: Ops
    result: Ref
    bc: BoundaryCondition | None = None


@dataclasses.dataclass(frozen=True)
class Stage:
    """An intermediate that the core program reads at several shifts.

    Its elements ``e`` lie in ``[0, base - trim)`` per axis, in the cells'
    integer coordinates; a cell ``c`` of the core reads it at ``e - c`` in
    the box ``lo..hi``. ``loads``, ``ops`` and ``result`` compute it at one
    element, its loads relative to that element."""

    trim: tuple[int, ...]
    lo: tuple[int, ...]
    hi: tuple[int, ...]
    loads: Loads
    ops: Ops
    result: Ref

    @property
    def footprint(self) -> tuple[tuple[int, int], ...]:
        """``lo..hi`` per axis, centred on the intermediate (shifted by half
        its trim): GP's ``re1 = inn(re) + ...`` is read at -1..1."""
        return tuple((lo + t // 2, hi + t // 2) for lo, hi, t in zip(self.lo, self.hi, self.trim))


@dataclasses.dataclass(frozen=True)
class CoreProgram:
    """Every output at one cell, in one shared program: ``loads`` relative
    to the cell, ``reads`` of the staged intermediates ``(stage, shift)``,
    and one result per output."""

    loads: Loads
    reads: tuple[tuple[int, tuple[int, ...]], ...]
    ops: Ops
    results: tuple[Ref, ...]


@dataclasses.dataclass(frozen=True)
class TapProgram:
    """One fused launch: the core program, its stages and every output's
    direct program, the host-evaluated scalar parameters and the reductions
    folded over the written cells."""

    ndim: int
    fields: tuple[str, ...]
    outputs: tuple[OutputProgram, ...]
    params: tuple[SymScalar, ...]
    reductions: tuple[tuple[str, Reduction], ...]
    offsets: tuple[tuple[int, ...], ...] = ()   # per field: base shape - field shape
    core: CoreProgram | None = None
    stages: tuple[Stage, ...] = ()
    # the kernel axis (x 0, y 1, z 2) of each program axis: by default
    # ``_AXES3[ndim]``; a marched program puts its march axis on x
    # (:func:`march_layout`)
    layout: tuple[int, ...] = ()

    @property
    def axes3(self) -> tuple[int, ...]:
        return self.layout or _AXES3[self.ndim]

    def to3(self, t: Sequence, fill) -> tuple:
        """A per-axis tuple of the program laid out on the kernel's axes."""
        return to3(t, fill, self.axes3)

    @property
    def z_strided(self) -> bool:
        """Whether the kernel's z axis is not the fields' contiguous one
        (a march along the contiguous axis): its offsets then carry a
        stride of their own, and a warp's loads are strided."""
        return self.ndim >= 2 and self.axes3[-1] != 2

    def host_values(self, scalars: Mapping[str, Any]) -> list:
        """The scalar parameters' values for one call."""
        return [p.evaluate(scalars) for p in self.params]

    def ops_per_cell(self) -> int:
        """f32 operations per core cell: the core program and each stage
        once (``x ** 2`` and ``x ** 3`` count as their products)."""
        return op_count(self.core.ops) + sum(op_count(s.ops) for s in self.stages)


def op_count(ops: Ops) -> int:
    """f32 operations of a program: ``x ** 2`` and ``x ** 3`` are one and
    two products, every other operation one."""
    return sum(int(args[1][1]) - 1 if kind == "pow" and args[1][0] == "const"
               and args[1][1] in (2, 3) else 1 for kind, args in ops)


class _Lowering:
    """Memoized lowering of expression nodes at shifts relative to one cell
    (``rel``: the node's element index less the cell's). Nodes in ``stops``
    are read from their stage instead of computed."""

    def __init__(self, params: dict[str, int], param_list: list[SymScalar],
                 stops: Mapping[int, int] | None = None):
        self.params = params
        self.param_list = param_list
        self.stops = dict(stops or {})
        self.loads: dict[tuple[str, tuple[int, ...]], int] = {}
        self.reads: dict[tuple[int, tuple[int, ...]], int] = {}
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

    def visit(self, node, rel: tuple[int, ...]) -> Ref:
        if isinstance(node, SymScalar):
            return self.scalar(node)
        memo_key = (id(node), rel)
        if memo_key in self.memo:
            return self.memo[memo_key]
        if node.op == "leaf":
            ref = ("load", self.loads.setdefault((node.name, rel), len(self.loads)))
        elif node.op == "slice":
            ref = self.visit(node.children[0],
                             tuple(r + st for r, st in zip(rel, node.starts)))
        elif id(node) in self.stops:
            ref = ("read", self.reads.setdefault((self.stops[id(node)], rel), len(self.reads)))
        else:
            ref = self.emit(node.op, tuple(self.visit(c, rel) for c in node.children))
        self.memo[memo_key] = ref
        return ref


def _reach(roots, stops=frozenset()) -> dict[int, tuple[Any, set]]:
    """The operation nodes reached from ``roots`` (``(node, rel)`` pairs),
    each with the shifts it is read at; nodes in ``stops`` are recorded but
    not entered."""
    found: dict[int, tuple[Any, set]] = {}
    seen = set()
    todo = list(roots)
    while todo:
        node, rel = todo.pop()
        if isinstance(node, SymScalar) or (id(node), rel) in seen or node.op == "leaf":
            continue
        seen.add((id(node), rel))
        if node.op == "slice":
            todo.append((node.children[0], tuple(r + s for r, s in zip(rel, node.starts))))
            continue
        found.setdefault(id(node), (node, set()))[1].add(rel)
        if id(node) not in stops:
            todo.extend((c, rel) for c in node.children)
    return found


def _choose_stages(roots, ndim: int) -> dict[int, tuple[Any, set]]:
    """The intermediates to stage, in the order :func:`_reach` meets them:
    the outermost operation nodes read at several shifts whose staging
    saves at least :data:`STAGE_MIN_SAVED_OPS` operations per cell. An
    intermediate read inside another one is recomputed there (one level of
    staging)."""
    def cost(node) -> int:
        low = _Lowering({}, [])
        low.visit(node, (0,) * ndim)
        return op_count(tuple(low.ops))

    stops = {i for i, (_, rels) in _reach(roots).items() if len(rels) > 1}
    while True:
        reached = {i: v for i, v in _reach(roots, stops).items() if i in stops}
        rejected = {i for i, (node, rels) in reached.items()
                    if cost(node) * (len(rels) - 1) < STAGE_MIN_SAVED_OPS}
        if not rejected:
            return reached
        stops -= rejected


def lower(ir: StencilIR, bcs: Mapping[str, BoundaryCondition] | None = None,
          march_axis: int | None = None) -> TapProgram:
    """The tap program of a traced update, with each output's boundary
    condition (``bcs``, normalized), laid out to march ``march_axis`` (by
    default the all-parallel layout, :func:`march_layout`)."""
    bcs = dict(bcs or {})
    nd = ir.ndim
    params: dict[str, int] = {}
    param_list: list[SymScalar] = []
    outputs = []
    roots = [(ir.exprs[o], tuple(-w for w in ir.write_rings[o])) for o in ir.out_names]
    for o, (expr, rel) in zip(ir.out_names, roots):
        low = _Lowering(params, param_list)
        result = low.visit(expr, rel)
        outputs.append(OutputProgram(
            name=o, modes=ir.write_modes[o], rings=ir.write_rings[o],
            loads=tuple(low.loads), ops=tuple(low.ops), result=result,
            bc=bcs.get(o)))
    chosen = _choose_stages(roots, nd)
    stages = []
    for node, rels in chosen.values():
        low = _Lowering(params, param_list)
        result = low.visit(node, (0,) * nd)
        stages.append(Stage(
            trim=tuple(b - s for b, s in zip(ir.base_shape, node.shape)),
            lo=tuple(min(r[a] for r in rels) for a in range(nd)),
            hi=tuple(max(r[a] for r in rels) for a in range(nd)),
            loads=tuple(low.loads), ops=tuple(low.ops), result=result))
    low = _Lowering(params, param_list, {i: k for k, i in enumerate(chosen)})
    results = tuple(low.visit(expr, rel) for expr, rel in roots)
    core = CoreProgram(loads=tuple(low.loads), reads=tuple(low.reads), ops=tuple(low.ops),
                       results=results)
    return TapProgram(ndim=nd, fields=tuple(ir.field_shapes),
                      outputs=tuple(outputs), params=tuple(param_list),
                      reductions=tuple(ir.reductions.items()),
                      offsets=tuple(ir.offsets[f] for f in ir.field_shapes),
                      core=core, stages=tuple(stages),
                      layout=() if march_axis is None else march_layout(nd, march_axis))


def core_box(program: TapProgram, out_shapes: Mapping[str, Sequence[int]]):
    """Per axis ``(lo, hi)``: the cells where every output is written by its
    update, inside its extent and off its boundary faces (dirichlet too).
    The core program computes these; None when there are none."""
    lo, hi = [0] * program.ndim, [math.inf] * program.ndim
    for op in program.outputs:
        axes = set(op.bc.resolved_axes(program.ndim)) if op.bc else set()
        for a, (m, r) in enumerate(zip(out_shapes[op.name], op.rings)):
            d = max(r, op.bc.depth if a in axes else 0)
            lo[a], hi[a] = max(lo[a], d), min(hi[a], m - d)
    if any(l >= h for l, h in zip(lo, hi)):
        return None
    return tuple(zip(lo, hi))


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


def _run(loads: Loads, ops: Ops, view, host, read=None):
    """Evaluate a program on tensors: ``view(field, off)`` gives a load's
    values, ``read(i)`` a staged read's. Returns the resolver of refs."""
    vals: list = []
    lv = [view(f, off) for f, off in loads]

    def resolve(ref):
        kind, v = ref
        if kind == "load":
            return lv[v]
        if kind == "read":
            return read(v)
        if kind == "op":
            return vals[v]
        if kind == "param":
            return host[v]
        return v

    for kind, args in ops:
        vals.append(_apply(kind, [resolve(a) for a in args]))
    return resolve


def evaluate_torch(program: TapProgram, fields: Mapping[str, torch.Tensor],
                   scalars: Mapping[str, Any], prev: Mapping[str, torch.Tensor] | None = None):
    """Run the tap program with torch operators on shifted views of
    ``fields``, as the kernel runs it: each output's direct program on its
    write region and faces, then the core program, reading each stage
    computed once as a whole tensor, on the core cells. A cell an output
    does not write keeps its ``prev`` value (by default the output's own).
    Fields stored in bf16 or f16 are widened to f32 first and each output
    is rounded to its storage dtype at the end, as the kernel stores it.
    Returns ``(outputs, reductions)``; ``reductions`` is None when the
    program has none (each folded in f32 over the stored values)."""
    host = program.host_values(scalars)
    stored = fields[program.fields[0]].dtype
    # stencil.default_compute_dtype's rule, which is also the accumulation
    # dtype: f32 for bf16 and f16 storage
    compute = torch.promote_types(stored, torch.float32)
    if compute != stored:
        fields = {n: t.to(compute) for n, t in fields.items()}
        prev = None if prev is None else {n: t.to(compute) for n, t in prev.items()}
    outs = {}
    for op in program.outputs:
        prev_op = fields[op.name] if prev is None else prev[op.name]

        def view(field, off, rings=op.rings, shape=prev_op.shape):
            # the output's region, shifted by the tap, in the field's own
            # index space
            return fields[field][tuple(slice(w + d, n - w + d)
                                       for w, d, n in zip(rings, off, shape))]

        out = prev_op.clone()
        out[tuple(slice(w, n - w) for w, n in zip(op.rings, prev_op.shape))] = \
            _run(op.loads, op.ops, view, host)(op.result)
        outs[op.name] = out if op.bc is None else apply_bc(out, op.bc)
    box = core_box(program, {o: tuple(t.shape) for o, t in outs.items()})
    if program.core is not None and box is not None:
        f0 = program.fields[0]
        base = [n + d for n, d in zip(fields[f0].shape, program.offsets[0])]
        staged = []
        for s in program.stages:
            ext = [b - t for b, t in zip(base, s.trim)]
            staged.append(_run(s.loads, s.ops, lambda f, off, ext=ext: fields[f][tuple(
                slice(d, d + n) for d, n in zip(off, ext))], host)(s.result))

        def window(t, off):
            return t[tuple(slice(lo + d, hi + d) for (lo, hi), d in zip(box, off))]

        core = program.core
        resolve = _run(core.loads, core.ops, lambda f, off: window(fields[f], off), host,
                       lambda i: window(staged[core.reads[i][0]], core.reads[i][1]))
        for op, res in zip(program.outputs, core.results):
            outs[op.name][tuple(slice(lo, hi) for lo, hi in box)] = resolve(res)
    if compute != stored:
        outs = {n: t.to(stored) for n, t in outs.items()}
    if not program.reductions:
        return outs, None
    reds = {}
    for name, r in program.reductions:
        ops = [(outs[f] if f in outs else fields[f]).to(compute) for f in r.operands]
        reds[name] = r.fold(r.map_element(*ops))
    return outs, reds


def evaluate_steps_torch(program: TapProgram, rotations: Mapping[str, str], nsteps: int,
                         fields: Mapping[str, torch.Tensor], scalars: Mapping[str, Any]):
    """``nsteps`` sweeps of :func:`evaluate_torch` with the k-step kernel's
    semantics (the reference's ``build_stencil_call(nsteps=k)``): each
    sweep's outputs become their rotation targets' values for the next; an
    intermediate sweep keeps the target's previous value where an output is
    not written, the last sweep the output's own; the reductions are the
    last sweep's."""
    cur = dict(fields)
    for s in range(int(nsteps) - 1):
        outs, _ = evaluate_torch(program, cur, scalars,
                                 prev={o: cur[rotations[o]] for o in rotations})
        for o, t in rotations.items():
            cur[t] = outs[o]
    return evaluate_torch(program, cur, scalars)


def check_batched(program: TapProgram, pairs: Mapping[str, str]) -> None:
    """``ValueError`` unless the program can run batched with ``pairs``
    (output to target): every output rotates into a field of its own that
    is not an output, and no output is read by the update (a batched
    launch writes each output in place, so a read of it at a shift could
    see a neighbour's new value)."""
    outs = [op.name for op in program.outputs]
    if set(pairs) != set(outs) or len(set(pairs.values())) != len(pairs) \
            or set(pairs.values()) & set(outs) or not set(pairs.values()) <= set(program.fields):
        raise ValueError(f"a batched launch needs every output {outs} rotating into a field "
                         f"of its own that is not an output; got rotations {dict(pairs)}")
    loads = [f for f, _ in program.core.loads]
    loads += [f for s in program.stages for f, _ in s.loads]
    loads += [f for op in program.outputs for f, _ in op.loads]
    read = sorted(set(loads) & set(outs))
    if read:
        raise ValueError(f"the update reads its outputs {read}; a batched launch writes each "
                         "output in place, so it cannot read one")


def sample_fields(bufs: Mapping[str, torch.Tensor], pairs: Mapping[str, str], b: int,
                  odd: bool) -> dict[str, torch.Tensor]:
    """Sample ``b``'s fields in a batch's buffers (``(B, *grid)`` each):
    at parity 0 each field lies in its own buffer, at parity 1 each field of
    a rotation pair (``pairs``: output to target) in its partner's."""
    partner = {**pairs, **{t: o for o, t in pairs.items()}}
    return {f: (bufs[partner[f]] if odd and f in partner else bufs[f])[b] for f in bufs}


def step_samples(step, pairs: Mapping[str, str], bufs: Mapping[str, torch.Tensor],
                 scalars: Sequence[Mapping[str, Any]], live: torch.Tensor, odd: torch.Tensor,
                 flip: int = 0, reductions: Sequence[str] = ()):
    """A batched step sample by sample: ``step(fields, scalars) -> (outs,
    reds)`` on each live sample ``b``'s fields (:func:`sample_fields` at
    parity ``odd[b] != flip``) with its scalars ``scalars[b]``, each output
    copied into its own buffer; a dead sample is not touched. Returns the
    ``reductions`` as ``(B,)`` f32 tensors, 0 for a dead sample (None
    without reductions)."""
    flags = list(zip(live.tolist(), odd.tolist()))
    dev = next(iter(bufs.values())).device
    reds = ({n: torch.zeros(len(flags), dtype=torch.float32, device=dev) for n in reductions}
            if reductions else None)
    for b, (alive, par) in enumerate(flags):
        if not alive:
            continue
        ins = sample_fields(bufs, pairs, b, bool(par) != bool(flip))
        outs, r = step(ins, scalars[b])
        for o, t in outs.items():
            ins[o].copy_(t)
        for n, v in (r or {}).items():
            reds[n][b] = v
    return reds


def evaluate_batch_torch(program: TapProgram, pairs: Mapping[str, str],
                         bufs: Mapping[str, torch.Tensor], scalars: Sequence[Mapping[str, Any]],
                         live: torch.Tensor, odd: torch.Tensor, flip: int = 0):
    """The batched kernel's plain version (:func:`cuda_source`'s
    ``batched``): :func:`evaluate_torch` on each live sample of the stacked
    buffers with its own scalars (:func:`step_samples`)."""
    return step_samples(
        lambda ins, sc: evaluate_torch(program, {f: ins[f] for f in program.fields}, sc),
        pairs, bufs, scalars, live, odd, flip, [n for n, _ in program.reductions])


# ----------------------------------------------------------------- CUDA form
# The kernel works on (x, y, z) and marches x. The all-parallel layout keeps
# z contiguous: a 3-D grid marches its first axis, a 2-D grid (n0, n1) is
# laid out as (n0, 1, n1) and marches n0, a 1-D grid is (1, 1, n).
_AXES3 = {1: (2,), 2: (0, 2), 3: (0, 1, 2)}


def march_layout(ndim: int, march_axis: int) -> tuple[int, ...]:
    """The kernel axis of each program axis in a launch marching
    ``march_axis``: it goes on x, and the others keep their order on y and z
    with the contiguous (last) one on z where it is not the march axis. A
    march along a 3-D grid's axis 1 swaps the roles of x and y, its loads
    still coalesced along z; a march along the contiguous axis (3-D axis 2,
    2-D axis 1, 1-D axis 0) puts a strided axis on z."""
    if not 0 <= march_axis < ndim:
        raise ValueError(f"march_axis {march_axis} out of range for ndims={ndim}")
    rest = [a for a in range(ndim) if a != march_axis]
    out = [0] * ndim
    out[march_axis] = 0
    for a, k in zip(rest, (1, 2) if len(rest) == 2 else (2,)):
        out[a] = k
    return tuple(out)
SHARED_LIMIT = 48 * 1024      # static shared memory of one block
# An async slab's steps start, and its copies' windows begin, on multiples
# of this many planes: a 32-byte sector of f32 along the contiguous axis, so
# a warp's loads and stores cover whole sectors.
ALIGN = 8
SM_SHARED = 227 * 1024        # shared memory of an H100 SM that blocks can use
# Async slab layouts (``KernelShape.async_copies``: (z, y) tile, planes per
# step) in order of preference, by rank and whether the program has stages:
# the first that fits. Measured best on the H100 (PERF.md, section 6): FIG1
# 16 x 4 with 16 planes; GP's stages and porosity's take 8 planes, whose
# queues leave more blocks resident.
SLABS = {(3, False): [((16, 4), 16), ((16, 8), 16), ((32, 4), 16), ((16, 8), 8)],
         (3, True): [((16, 8), 8), ((32, 8), 8), ((32, 4), 8), ((16, 4), 8)],
         (2, False): [((64, 1), 8), ((128, 1), 8), ((64, 1), 16)],
         (2, True): [((64, 1), 8), ((128, 1), 8), ((64, 1), 16)]}
# The synchronous slab's (``async_copies`` off): 16 planes (64 bytes of f32 along the
# contiguous axis per cell and step) in a short tile first; measured best
# on the H100 for FIG1 and porosity, while GP's larger queues keep 8 planes.
SYNC_SLABS = {3: [((32, 4), 16), ((16, 4), 16), ((16, 8), 8), ((32, 4), 8), ((16, 4), 8),
                  ((16, 8), 4)],
              2: [((64, 1), 16), ((128, 1), 8), ((64, 1), 8), ((128, 1), 4)]}


@dataclasses.dataclass(frozen=True)
class KernelShape:
    """How a generated kernel is laid out: ``tile`` threads of a block along
    (z, y), ``planes`` each block writes per step of its march (the core
    program runs on them unrolled, so their loads are in flight together,
    and the stages pass one barrier per step), and ``min_blocks`` of them
    kept resident on an SM (``__launch_bounds__``: it caps the registers).
    ``slab`` (a march along the contiguous axis only) stages every field
    the core and the stages read into plane queues in shared memory, each
    step's planes loaded planes-fastest, so a warp reads whole 32-byte
    sectors of the contiguous axis instead of one word of 32 rows
    (:func:`field_queues`), and stores each output's step of planes from
    shared memory, planes-fastest too. With ``async_copies`` the queues
    fill by asynchronous copies issued a step ahead (:func:`_emit_copies`)
    and the step's outputs go out a step later, one barrier a step;
    without, each step loads its queues through registers and stores its
    outputs behind two barriers of its own (PERF.md, section 6)."""

    tile: tuple[int, int]
    planes: int
    min_blocks: int
    slab: bool = False
    async_copies: bool = False
    # cells of the contiguous axis a thread owns: above 1, the pair layout
    # for 2-byte fields (``kernels/codegen_pairs.py``)
    vec: int = 1
    # threads of a block where they are not one a cell of the tile: the
    # all-parallel k-step kernel (``kernels/codegen_steps.py``), whose
    # threads walk each phase's region, its tile and halo, in rounds
    block: int = 0
    # the batched column march (``kernels/codegen_columns.py``), and the
    # planes its loads run ahead of the plane it computes, beyond the taps'
    # reach
    column: bool = False
    ahead: int = 0

    @property
    def threads(self) -> int:
        return self.block or self.tile[0] * self.tile[1]

    @property
    def cells(self) -> tuple[int, int]:
        """The block's cells along (z, y)."""
        return self.tile[0] * self.vec, self.tile[1]


def layout_name(shape: KernelShape) -> str:
    """A layout's short name: tile, planes per step, resident blocks, and
    ``/slab`` (synchronous staging) or ``/slab-async``, or ``/v{vec}`` (the
    pair layout, ``vec`` cells a thread), or ``/t{block}`` (threads of a
    block apart from the tile's cells), or ``/col`` (the batched column
    march) and ``/a{ahead}`` (its loads that many planes further ahead)."""
    kind = ("/slab-async" if shape.async_copies else "/slab") if shape.slab else ""
    kind += f"/v{shape.vec}" if shape.vec > 1 else ""
    kind += f"/t{shape.block}" if shape.block else ""
    kind += "/col" + (f"/a{shape.ahead}" if shape.ahead else "") if shape.column else ""
    return f"{shape.tile[0]}x{shape.tile[1]}/p{shape.planes}/b{shape.min_blocks}{kind}"


class LayoutRefused(NotImplementedError):
    """A printer's refusal of one layout (its shared memory, its rounds of
    threads, a queue wider than a copy's masks): another layout may serve
    the same launch, where a plain ``NotImplementedError`` says the kernel
    does not port the update at all."""


def layout_refusal(program: TapProgram, shape: KernelShape, steps: bool) -> str | None:
    """Why ``shape`` cannot lay out a solo launch of ``program`` (a single
    step, or with ``steps`` the k-step kernel), or None: the rules a layout
    chosen by the caller (``parallel(tile=)``, the autotuner) is held to
    before anything is printed. The printers' own refusals (shared memory,
    rounds of threads: :class:`LayoutRefused`) come after these."""
    threads = shape.threads
    if shape.column:
        return "the column march is a batched layout"
    if min(shape.tile) < 1 or shape.planes < 1 or shape.min_blocks < 1:
        return "tile, planes and resident blocks must be positive"
    if 1 not in program.axes3 and shape.tile[1] != 1:
        return (f"a tile of {shape.tile[1]} rows along y, where this launch of a "
                f"{program.ndim}-d update has one")
    if threads % 32 or threads > 1024:
        return f"{threads} threads a block: whole warps, at most 1024"
    if threads * shape.min_blocks > 2048:
        return f"{shape.min_blocks} resident blocks of {threads} threads exceed an SM's 2048"
    if shape.slab and not program.z_strided:
        return "a slab serves a march along the contiguous axis"
    if shape.slab and threads % shape.planes:
        return f"a slab's {shape.planes} planes must divide its {threads} threads"
    if shape.block and (not steps or program.layout):
        return "threads apart from the tile's cells serve the all-parallel k-step kernel"
    if shape.vec > 1 and steps:
        return "the pair layout serves single steps"
    return None


def to3(t: Sequence, fill, layout: Sequence[int] | None = None) -> tuple:
    """A rank-1..3 tuple laid out on the kernel's (x, y, z) axes (by
    ``layout``, the kernel axis of each entry; by default the all-parallel
    layout)."""
    out = [fill] * 3
    for a, v in zip(layout or _AXES3[len(t)], t):
        out[a] = v
    return tuple(out)


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


def _all_ops(program: TapProgram):
    yield from (a for op in program.outputs for a in op.ops)
    if program.core is not None:
        yield from program.core.ops
    yield from (a for s in program.stages for a in s.ops)


def divisor_params(program: TapProgram) -> tuple[int, ...]:
    """The scalar parameters that divide a tensor: the launch passes each
    one's :func:`reciprocal` as well, after the parameters."""
    return tuple(sorted({args[1][1] for kind, args in _all_ops(program)
                         if kind == "div" and args[1][0] == "param"
                         and args[0][0] in ("load", "read", "op")}))


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


def _combine(kind: str, acc: str, val: str) -> str:
    return f"max_nan({acc}, {val})" if kind == "max" else f"({acc} + {val})"


def fold_line(r: int, red: Reduction, vals: Sequence[str], acc: str | None = None) -> str:
    """The statement folding reduction ``r`` at one cell into ``acc{r}`` (or ``acc``):
    its elementwise map of the operands' f32 values ``vals`` (an output's
    stored value, widened), then its combine. The ``finite`` and
    ``nan_count`` indicator is 1 for NaN and inf (``|v| < inf`` is false for
    both) and 0 otherwise, so it is never NaN, and a block's count of at
    most 2^24 cells is exact in f32."""
    if red.kind == "max_abs":
        m = f"fabsf({vals[0]})"
    elif red.kind == "max_abs_diff":
        m = f"fabsf({vals[0]} - {vals[1]})"
    elif red.kind == "sum":
        m = vals[0]
    elif red.kind == "sum_sq":
        m = f"{vals[0]} * {vals[0]}"
    elif red.kind in ("finite", "nan_count"):
        m = f"fabsf({vals[0]}) < {float_literal(math.inf)} ? 0.0f : 1.0f"
    else:
        raise NotImplementedError(f"reduction kind {red.kind!r} is not ported to the CUDA kernel")
    acc = acc or f"acc{r}"
    return f"{acc} = {_combine(red.combine, acc, f'({m})')};"


def stride_names(program: TapProgram) -> list[str]:
    """The stride arguments of the kernel, two per shape class (x, y), or
    three (x, y, z) where z is strided."""
    axes = ("x", "y", "z") if program.z_strided else ("x", "y")
    return [f"s{c}{ax}" for c in range(len(shape_classes(program))) for ax in axes]


def block_origin(w, program: TapProgram) -> None:
    """Print the block's origin (x0, y0, z0). Chunks along x are the
    slowest grid dimension, but the fastest where z is strided (a march
    along the contiguous axis): the blocks that run together then read
    neighbouring segments of the same rows, the same DRAM pages, instead of
    one short segment of many rows each."""
    if program.z_strided:
        w("  const int x0 = blockIdx.x * static_cast<int>(xc);")
        w("  const int z0 = blockIdx.y * kBlockZ, y0 = blockIdx.z * kBlockY;")
    else:
        w("  const int z0 = blockIdx.x * kBlockZ, y0 = blockIdx.y * kBlockY;")
        w("  const int x0 = blockIdx.z * static_cast<int>(xc);")


def grid_dims(program: TapProgram) -> str:
    """The launch's grid from the blocks along z and y and the chunks
    (``gz``, ``gy``, ``gx``), in :func:`block_origin`'s order."""
    dims = ("gx", "gz", "gy") if program.z_strided else ("gz", "gy", "gx")
    return ", ".join(f"static_cast<unsigned>({d})" for d in dims)


def _emit_strides(w, c: int, zs: bool, sample: bool = False) -> None:
    """Shape class ``c``'s 32-bit strides inside a block and its 64-bit
    block base (with ``sample``, in sample ``bs`` of a stack of fields of
    ``m{c}x * s{c}x`` cells each)."""
    if sample:
        w(f"  const int S{c}x = static_cast<int>(s{c}x), S{c}y = static_cast<int>(s{c}y);")
        w(f"  const int64_t b{c} = bs * (m{c}x * s{c}x) + x0 * s{c}x + y0 * s{c}y + z0;")
    elif zs:
        w(f"  const int S{c}x = static_cast<int>(s{c}x), S{c}y = static_cast<int>(s{c}y), "
          f"S{c}z = static_cast<int>(s{c}z);")
        w(f"  const int64_t b{c} = x0 * s{c}x + y0 * s{c}y + z0 * s{c}z;")
    else:
        w(f"  const int S{c}x = static_cast<int>(s{c}x), S{c}y = static_cast<int>(s{c}y);")
        w(f"  const int64_t b{c} = x0 * s{c}x + y0 * s{c}y + z0;")


def _emit_sample(w, program: TapProgram, divs: Sequence[int]) -> None:
    """A batched kernel's block origin (:func:`cuda_source`'s ``batched``):
    its sample ``bs`` and chunk from ``blockIdx.z`` (samples slowest, so
    the blocks of one sample run together), a dead sample's early return
    with its block's partials 0, the parity ``par`` of the sample's pairs
    at this launch, and its scalars: the parameters, then the divisors'
    reciprocals, one row of ``prm`` a sample."""
    n_par = len(program.params)
    w("  // blockIdx.z runs over (sample, chunk), samples slowest")
    w("  const int chunks = static_cast<int>((nx + xc - 1) / xc);")
    w("  const int64_t bs = static_cast<int>(blockIdx.z) / chunks;  // the sample")
    w("  const int z0 = blockIdx.x * kBlockZ, y0 = blockIdx.y * kBlockY;")
    w("  const int x0 = (static_cast<int>(blockIdx.z) - static_cast<int>(bs) * chunks) * "
      "static_cast<int>(xc);")
    w("  if (!live[bs]) {  // a dead sample: no byte of its buffers moves")
    if program.reductions:
        w("    if (tid == 0) {")
        w("      const int64_t bid = (static_cast<int64_t>(blockIdx.z) * gridDim.y + "
          "blockIdx.y) * gridDim.x + blockIdx.x;")
        for r in range(len(program.reductions)):
            w(f"      part{r}[bid] = 0.0f;")
        w("    }")
    w("    return;")
    w("  }")
    w("  const bool par = odd[bs] != (flip != 0);  // its pairs' buffers swapped")
    if n_par or divs:
        w(f"  const float* const prs = prm + bs * {n_par + len(divs)};  // its scalars")
    for k in range(n_par):
        w(f"  const float p{k} = prs[{k}];")
    for i, k in enumerate(divs):
        w(f"  const float r{k} = prs[{n_par + i}];")


def shape_classes(program: TapProgram) -> tuple[tuple[int, int, int], ...]:
    """The distinct staggering offsets of the program's fields, on the
    kernel's (x, y, z) axes: fields of one class share extents and strides,
    and the launch passes one pair of strides per class."""
    return tuple(sorted({program.to3(o, 0) for o in program.offsets}))


def march_reach(program: TapProgram) -> tuple[int, int]:
    """``(lo, hi)``: the shifts along the march axis at which the core
    program reads its stages ((0, 0) without stages)."""
    if not program.stages:
        return 0, 0
    return (min(program.to3(s.lo, 0)[0] for s in program.stages),
            max(program.to3(s.hi, 0)[0] for s in program.stages))


# The pair layout for fields stored at 2 bytes (``KernelShape.vec``,
# ``kernels/codegen_pairs.py``), by rank, whether the program has stages and
# whether it has reductions: the fastest without spills on the H100
# (``launch/tune_stencil.py --dtype bfloat16``; PERF.md, section 6). The
# all-parallel programs not listed keep the one-cell layout at every
# storage width.
PAIRS = {(2, True, False): KernelShape((128, 1), 2, 6, vec=4),
         (2, True, True): KernelShape((128, 1), 2, 6, vec=4),
         (3, True, False): KernelShape((16, 8), 2, 7, vec=2),
         (3, True, True): KernelShape((16, 8), 4, 6, vec=2),
         (3, False, False): KernelShape((16, 8), 2, 10, vec=2),
         (3, False, True): KernelShape((16, 8), 4, 10, vec=2)}


def pair_shape(program: TapProgram) -> KernelShape | None:
    """The program's pair layout (:data:`PAIRS`), or None."""
    return PAIRS.get((program.ndim, bool(program.stages), bool(program.reductions)))


def kernel_shape(program: TapProgram, dtype: torch.dtype = torch.float32) -> KernelShape:
    """The layout of the program's kernel for fields stored as ``dtype``:
    for 2-byte storage of an all-parallel program in :data:`PAIRS`, its pair
    layout (``kernels/stencil.py`` takes it where the fields' extents and
    addresses allow, :func:`codegen_pairs.fits`); else the fastest on the H100 without
    register spills over the candidates of ``launch/tune_stencil.py``
    (PERF.md, section 6). Six resident blocks of 256 threads (40 registers), but
    five (48) for a program with stages, which can spill at 40; four planes
    per step for a staged program, whose loads the stages already hold
    back behind a barrier, but two for a staged 3-D program with
    reductions (GP's mass epilogue spills at four) and for a program
    without stages. A march along the contiguous axis takes an async slab
    layout (``KernelShape.async_copies``, :data:`SLABS`; PERF.md, section
    6: strided loads and stores ran 13-18x slower than the all-parallel
    kernel, the synchronous slab 2.8-4.2x)."""
    if program.z_strided and (slab := slab_layout(program)) is not None:
        return slab
    if not storage(dtype).wide and not program.layout and (pair := pair_shape(program)):
        return pair
    planes = 4 if program.stages and not (program.ndim == 3 and program.reductions) else 2
    return KernelShape(base_tile(program), planes, 5 if program.stages else 6)


# The layout of a batched kernel (:func:`cuda_source`'s ``batched``) by
# rank, whether the program has stages, whether it has reductions and
# whether its fields are stored at 4 bytes (``wide``): the fastest without
# spills at 16 samples a launch on the H100 at f32 and bf16
# (``launch/tune_stencil.py --batched [--dtype bfloat16]``: the serving
# demo's diffusion step at 128^3 plain and with its check and guard,
# porosity's fused update with its check at 1024^2, GP's with its mass sums
# at 128^3; PERF.md, section 6). A 3-D program without stages takes the
# column march (``kernels/codegen_columns.py``), its guarded check at 4 or
# 5 resident blocks (it spills at 6); the others the one-cell layout.
BATCHED = {(3, False, False, True): KernelShape((64, 4), 2, 8, column=True),
           (3, False, True, True): KernelShape((32, 8), 2, 4, column=True, ahead=4),
           (2, True, True, True): KernelShape((128, 1), 2, 5),
           (3, True, True, True): KernelShape((32, 8), 4, 5),
           (3, False, False, False): KernelShape((64, 4), 2, 8, column=True),
           (3, False, True, False): KernelShape((32, 8), 2, 5, column=True),
           (2, True, True, False): KernelShape((128, 1), 4, 8),
           (3, True, True, False): KernelShape((32, 8), 4, 5)}


def batch_shape(program: TapProgram, dtype: torch.dtype = torch.float32) -> KernelShape:
    """The layout of a batched kernel for fields stored as ``dtype``:
    :data:`BATCHED`'s for its kind of program (the column march or the
    one-cell layout, one cell a thread at every storage width), else
    :func:`kernel_shape`'s one-cell layout."""
    key = (program.ndim, bool(program.stages), bool(program.reductions), storage(dtype).wide)
    return BATCHED.get(key, kernel_shape(program))


def slab_layout(program: TapProgram, async_copies: bool = True) -> KernelShape | None:
    """A march along the contiguous axis: the first slab of :data:`SLABS`
    that fits (None if none does); without ``async_copies`` the
    synchronous slab, the first of :data:`SYNC_SLABS` that fits and keeps
    512 threads resident, else the last that fits."""
    if async_copies:
        return next((s for tile, planes in SLABS[(program.ndim, bool(program.stages))]
                     if (s := slab_shape(program, tile, planes)) is not None), None)
    fits = [s for tile, planes in SYNC_SLABS[program.ndim]
            if (s := slab_shape(program, tile, planes, False)) is not None]
    busy = [s for s in fits if s.min_blocks * s.threads >= 512]
    return busy[0] if busy else fits[-1] if fits else None


def slab_shape(program: TapProgram, tile: tuple[int, int], planes: int,
               async_copies: bool = True) -> KernelShape | None:
    """A slab layout of ``tile`` and ``planes``, as many blocks resident as
    its queues leave an SM's shared memory for (and at least 64 registers a
    thread), or None where one block's queues exceed what a block can have:
    227 KB of dynamic shared memory with ``async_copies``, 48 KB of static
    shared memory without (or where the planes do not divide the threads,
    which the copies are cut by)."""
    threads = tile[0] * tile[1]
    if async_copies and threads % planes:
        return None
    smem = shared_bytes(program, KernelShape(tile, planes, 1, True, async_copies))
    if smem > (SM_SHARED if async_copies else SHARED_LIMIT):
        return None
    # resident blocks: as many as shared memory holds, but registers for 64
    # a thread at least (a slab's 2-D staggered update spilled at 32)
    return KernelShape(tile, planes, max(1, min(SM_SHARED // smem, 65536 // (64 * threads))),
                       True, async_copies)


def base_tile(program: TapProgram, wide: tuple[int, int] = (32, 8)) -> tuple[int, int]:
    """The (z, y) threads of a block: ``wide`` for a 3-D program, one row of
    256 in 2-D and 1-D, and one warp where no program axis lies on z (a
    1-D march, whose threads along z would all idle but one)."""
    if 2 not in program.axes3:
        return (32, 1)
    return wide if program.ndim == 3 else (256, 1)


def queue_planes(program: TapProgram, shape: KernelShape) -> int:
    """Planes of each stage's queue kept in shared memory: a step reads
    ``planes - 1 + hi - lo + 1`` of them while the next stages ``planes``
    more, with one barrier between (0 without stages or field queues). A
    slab kernel's steps pass a barrier after the last reads of their
    planes, so the next step stages into the planes this one read; with
    ``async_copies`` each field queue keeps its own planes
    (:func:`ring_planes`) and a stage's queue only the stages' reach."""
    if shape.slab and shape.async_copies:
        lo, hi = march_reach(program)
        return hi - lo + shape.planes if program.stages else 0
    if not (program.stages or shape.slab):
        return 0
    return march_lag(program, shape) + (1 if shape.slab else 2) * shape.planes


def ring_planes(box, planes: int) -> int:
    """Planes of an async slab's field queue of ``box`` (``(lo, hi)`` on the
    kernel's axes): a step reads its ``planes`` and the queue's reach behind
    and ahead of them (ahead rounded up to :data:`ALIGN`) while the next
    step's planes arrive."""
    return 2 * planes + aligned(box[1][0]) - box[0][0]


def march_lag(program: TapProgram, shape: KernelShape | None = None) -> int:
    """Planes a chunk stages before it writes its first: the stages' reach
    along the march axis, and with ``shape.slab`` each field queue's (an
    async slab copies its field queues' planes behind its first step
    before it starts, and rounds its lag up to :data:`ALIGN`, so that its
    steps begin on whole sectors)."""
    lo, hi = march_reach(program)
    lag = hi - lo
    if shape is not None and shape.slab and shape.async_copies:
        return aligned(lag)
    if shape is not None and shape.slab:
        lag = max([lag] + [h[0] - l[0] for l, h in field_queues(program).values()])
    return lag


def field_queues(program: TapProgram) -> dict[str, tuple[tuple[int, ...], tuple[int, ...]]]:
    """``{field: (lo, hi)}`` on the kernel's axes: the cells around a core
    cell at which the core program or a stage reads each field (a stage
    element read at shift ``d`` reads its taps at ``d + t``), what a slab
    kernel's field queue holds."""
    boxes: dict = {}

    def add(f, lo, hi):
        b = boxes.get(f)
        boxes[f] = (lo, hi) if b is None else (tuple(map(min, b[0], lo)), tuple(map(max, b[1], hi)))

    for f, off in program.core.loads:
        o = program.to3(off, 0)
        add(f, o, o)
    for s in program.stages:
        lo, hi = program.to3(s.lo, 0), program.to3(s.hi, 0)
        for f, off in s.loads:
            t = program.to3(off, 0)
            add(f, tuple(a + b for a, b in zip(lo, t)), tuple(a + b for a, b in zip(hi, t)))
    return boxes


def field_tile(box, shape: KernelShape) -> tuple[int, int]:
    """Rows and columns (y, z) of one plane of a field queue."""
    lo, hi = box
    return shape.tile[1] + hi[1] - lo[1], shape.tile[0] + hi[2] - lo[2]


def stage_tile(program: TapProgram, s: Stage, shape: KernelShape) -> tuple[int, int]:
    """Rows and columns (y, z) of one plane of a stage in shared memory:
    the block's tile and the halo its readers reach."""
    lo, hi = program.to3(s.lo, 0), program.to3(s.hi, 0)
    return shape.tile[1] + hi[1] - lo[1], shape.tile[0] + hi[2] - lo[2]


def plane_words(cells: int, planes: int) -> int:
    """Words of one plane of a field queue of ``cells`` cells in a slab
    kernel whose steps copy ``planes`` planes: padded so that the copies
    of a warp, planes fastest, land in 32 different banks (at most
    ``32 // planes`` cells of a warp share a plane)."""
    want = (32 // planes) % 32 if planes < 32 else 1
    return cells + (want - cells) % 32


def out_row(shape: KernelShape) -> int:
    """Words of one plane of an async slab's step buffer: the block's cells
    and a pad, so that its stores, planes fastest, read 32 banks."""
    return shape.threads + ((32 // shape.planes) % 32 if shape.planes < 32 else 1)


def shared_bytes(program: TapProgram, shape: KernelShape | None = None) -> int:
    """Shared memory of one block: the stages' plane queues, a slab
    kernel's field queues and its outputs' step buffer (4 bytes a value
    counted, whatever the storage; two step buffers with
    ``async_copies``), and the reduction fold's one value per warp and
    reduction. Static, but dynamic with ``async_copies``."""
    shape = shape or kernel_shape(program)
    if shape.vec > 1:
        from . import codegen_pairs
        return codegen_pairs.shared_bytes(program, shape)
    if shape.column:
        from . import codegen_columns
        return codegen_columns.shared_bytes(program, shape)
    cells = sum(math.prod(stage_tile(program, s, shape)) for s in program.stages)
    words = cells * queue_planes(program, shape)
    if shape.slab and shape.async_copies:
        words += sum(plane_words(math.prod(field_tile(b, shape)), shape.planes)
                     * ring_planes(b, shape.planes) for b in field_queues(program).values())
        words += 2 * len(program.outputs) * shape.planes * out_row(shape)
    elif shape.slab:
        words += sum(math.prod(field_tile(b, shape)) for b in field_queues(program).values()) \
            * queue_planes(program, shape)
        words += len(program.outputs) * shape.planes * shape.threads   # at most 4 bytes each
    return 4 * (words + len(program.reductions) * (shape.threads // 32))


def _zs(e: str, c: int, zs: bool, stride: str = "S") -> str:
    """``e`` cells along the kernel's z in a field of class ``c``: times the
    z stride where z is strided (:attr:`TapProgram.z_strided`)."""
    return f"({e}) * {stride}{c}z" if zs else e


def _index(coords: Sequence[str], c: int, zs: bool = False) -> str:
    """The flat index of the cell at ``coords`` in a field of class ``c``
    (z contiguous unless ``zs``)."""
    return f"{coords[0]} * s{c}x + {coords[1]} * s{c}y + {_zs(coords[2], c, zs, 's')}"


def _offset(base: str, c: int, off: tuple[int, ...], stride: str = "s", zs: bool = False) -> str:
    """``base`` moved by the tap ``off`` in a field of class ``c``, with the
    strides ``{stride}{c}x``, ``{stride}{c}y`` (and ``{stride}{c}z`` where
    ``zs``)."""
    terms = ""
    for d, s in zip(off, (f"{stride}{c}x", f"{stride}{c}y", f"{stride}{c}z" if zs else "")):
        if not d:
            continue
        term = f"{abs(d)} * {s}" if s and abs(d) != 1 else (s or str(abs(d)))
        terms += f" {'+' if d > 0 else '-'} {term}"
    return f"{base}{terms}"


def _printer(load: str, read: str, op: str):
    def ref(r: Ref) -> str:
        kind, v = r
        if kind == "load":
            return f"{load}{v}"
        if kind == "read":
            return f"{read}{v}"
        if kind == "op":
            return f"{op}{v}"
        if kind == "param":
            return f"p{v}"
        return float_literal(v)
    return ref


def _emit_ops(w, ind: str, ops: Ops, name: str, ref) -> None:
    for j, (kind, args) in enumerate(ops):
        w(f"{ind}const float {name}{j} = {_c_expr(kind, [ref(a) for a in args], list(args))};")


def cuda_source(program: TapProgram, shape: KernelShape | None = None,
                dtype: torch.dtype = torch.float32, part: str | None = None,
                batched: Mapping[str, str] | None = None) -> str:
    """CUDA C++ source of the fused launch for fields stored as ``dtype``
    (f32, bf16 or f16; computed in f32): one ``__global__`` function and
    a plain C entry point ``launch``. The base extents, one pair of strides
    per shape class and the grid are runtime arguments, so one build serves
    every grid size; the staggering offsets, the stages' footprints and the
    tile are fixed by the program.

    A block owns a tile of (y, z) columns and marches a chunk of x planes
    (:func:`to3` lays out lower ranks), ``planes`` per step
    (:class:`KernelShape`, by default :func:`kernel_shape`). A step first
    stages, for each intermediate, the next ``planes`` planes
    (``march_reach()[1]`` ahead of the planes it writes) over its tile and
    halo into a rolling queue in shared memory, then passes one barrier and
    writes its planes. An element outside the intermediate's frame is
    computed at the nearest element inside (its loads stay in range) and
    stored as 0; no written cell reads it. A thread whose step lies wholly
    in the core runs the core program on its planes, unrolled and without a
    branch, so their loads are in flight together; any other step goes cell
    by cell, a core cell through the core program and any other through
    each output's direct program as before: its update inside its write
    region, its previous value on the ring, its dirichlet value on a face,
    and on a neumann0 or periodic face the same expression at its source
    cell (:func:`bc_source`), so it equals that cell's own value bitwise.
    Reductions fold every output after its boundary condition and its
    rounding to storage, in f32 registers over the march, then across the
    block with warp shuffles.

    A slab (``shape.slab``) reads the fields the core and the stages read
    from plane queues in shared memory and writes its outputs through a
    step buffer there, both planes-fastest (:class:`KernelShape`). ``part``
    prints a timing variant (``launch/tune_stencil.py --split``): of a slab,
    "stage" (the field queues' staging alone) or "compute" (staging and
    compute without the stores); of the all-parallel kernel, "load" (every
    load of the stages and the core program, widened, and the barriers; no
    operation, no staging, no store) or "compute" (all but the core cells'
    stores, their rounded values kept). What a part drops it folds into a
    value stored only if it equals 1e38, so the compiler keeps the work; the
    cells outside the core (faces, rings) run whole in every part.

    ``batched`` (the kernel's rotations, each output to its target) prints
    the sample axis of a batched solve (:func:`_emit_sample`): fields
    stacked ``(B, *grid)``, each rotation's two buffers swapped per sample
    by a parity, each output written in place into its own buffer, each
    sample's scalars read from a ``(B, params)`` array, dead samples
    skipped, and the partials indexed by (sample, block). It takes the
    one-cell all-parallel layout, or with ``shape.column`` the column march
    of ``kernels/codegen_columns.py``."""
    if program.ndim > 3:
        raise NotImplementedError("the generated CUDA kernel handles 1-3 dimensions")
    st = storage(dtype)
    shape = shape or kernel_shape(program)
    if shape.column:
        if batched is None or part:
            raise ValueError(f"the column march {layout_name(shape)} is a batched layout "
                             "and has no timing parts")
        from . import codegen_columns
        return codegen_columns.cuda_source(program, shape, st, batched)
    if batched is not None and (shape.vec > 1 or shape.slab or program.layout or part):
        raise ValueError(f"a batched launch takes the one-cell all-parallel layout or the "
                         f"column march, not {layout_name(shape)}"
                         + (" marched" if program.layout else ""))
    if shape.vec > 1:
        if st.wide or shape.slab or program.layout:
            raise ValueError(f"the pair layout {layout_name(shape)} serves 2-byte fields of an "
                             "all-parallel launch")
        from . import codegen_pairs
        return codegen_pairs.cuda_source(program, shape, st, part)
    (bz, by), planes = shape.tile, shape.planes
    fidx = {f: k for k, f in enumerate(program.fields)}
    classes = shape_classes(program)
    fcls = {f: classes.index(program.to3(o, 0)) for f, o in zip(program.fields, program.offsets)}
    n_out, n_red, n_par = len(program.outputs), len(program.reductions), len(program.params)
    zs = program.z_strided
    core = program.core
    stages = program.stages
    lo_x, hi_x = march_reach(program)
    lead = march_lag(program, shape)
    # a slab kernel's field queues: {field: (lo, hi)} on the kernel's axes
    fq = field_queues(program) if shape.slab else {}
    pipe = bool(fq) and shape.async_copies
    queues = slab_queues(fq, shape, fidx, fcls) if pipe else []
    # how far ahead of a step's first plane each field queue's window begins
    ahead = {q.field: q.ahead for q in queues} if pipe else {f: b[1][0] for f, b in fq.items()}

    ring_of = {q.field: q.slots for q in queues}

    def fslot(f, rel: str) -> str:
        """The slot of a field queue's plane ``rel`` planes from the first of
        the window a step reads: each queue its own ring with async copies."""
        if pipe:
            return f"ring(fb{fidx[f]} + {rel}, {ring_of[f]})"
        return f"wrap(base + {rel})"
    queued = bool(stages or fq)
    dims = ("nx", "ny", "nz")
    strides = stride_names(program)
    lines = []
    w = lines.append
    w("// Generated by repro_torch.kernels.codegen from a traced @parallel update.")
    w("// Replaces the generic Pallas launch src/repro/kernels/stencil.py::")
    w("// build_stencil_call for this update. A block owns a tile of (y, z)")
    w("// columns, threadIdx.x along z (the contiguous axis), and marches a chunk")
    w("// of x planes, kPlanes per step; intermediates read at several shifts are")
    w("// staged once per cell in shared memory. Offsets inside a block are")
    w("// 32-bit, from a 64-bit block base.")
    if program.layout:
        w(f"// Marched layout: program axis a on kernel axis {program.axes3}[a] (x 0, y 1,")
        w("// z 2)" + ("; z is strided, so a warp's loads are strided" if zs else "") + ".")
    if pipe:
        w("// Slab: x is the contiguous axis. What bounds it on the H100 is bytes in")
        w("// flight: each field the core and the stages read is copied into a plane")
        w("// queue in shared memory by asynchronous copies (cp.async), planes fastest,")
        w("// each thread's offsets computed once before the march, a step's copies")
        w("// issued before the step ahead computes (double buffering); the outputs")
        w("// of a step go out from a step buffer, planes fastest, during the next")
        w("// step. One barrier a step (two with stages); queue planes and the step")
        w("// buffer are padded so that copies and stores use 32 banks.")
    elif fq:
        w("// Slab: each field the core and the stages read is staged per step into a")
        w("// plane queue in shared memory, kPlanes planes along the contiguous x per")
        w("// cell loaded together, so a warp reads whole sectors.")
    if part:
        w(f"// Timing variant: {part} only.")
    if batched is not None:
        w("// Batched: fields are stacked (B, *grid) and blockIdx.z runs over (sample,")
        w("// chunk). Each rotation's two buffers swap per sample by its parity; a live")
        w("// sample's output is written in place into its own buffer, a dead sample's")
        w("// blocks return at once. Scalars are per sample, partials per (sample, block).")
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
    w(f"constexpr int kPlanes = {planes};  // planes per step")
    if stages or (fq and not pipe):
        w(f"constexpr int kSlots = {queue_planes(program, shape)};  // planes kept per "
          + ("queue" if fq and not pipe else "stage"))
        if stages:
            w(f"constexpr int kHi = {hi_x};  // a step stages the planes this far ahead")
        w("")
        w("__device__ __forceinline__ int wrap(int s) {")
        w("  return s < 0 ? s + kSlots : s >= kSlots ? s - kSlots : s;")
        w("}")
    if pipe:
        w("constexpr int kGroups = kThreads / kPlanes;  // threads per plane of a copy or store")
        w(f"constexpr int kOutRow = {out_row(shape)};  // words of a step buffer's plane")
        smem = shared_bytes(program, shape) - 4 * n_red * (shape.threads // 32)
        w(f"constexpr int kShared = {smem};  // dynamic bytes")
        w("")
        for line in ring_helper() + [""] + copy_helpers(st):
            w(line)
    w("")
    w("// max that propagates NaN, as torch.amax does")
    w("__device__ __forceinline__ float max_nan(float a, float b) {")
    w("  return (b != b || b > a) ? b : a;")
    w("}")
    w("")
    T = st.ctype
    divs = divisor_params(program)
    if batched is None:
        params = [f"const {T}* __restrict__ in{k}" for k in range(len(program.fields))]
        params += [f"{T}* __restrict__ out{k}" for k in range(n_out)]
        params += [f"float* __restrict__ part{k}" for k in range(n_red)]
        params += [f"const float p{k}" for k in range(n_par)]
        params += [f"const float r{k}" for k in divs]
    else:
        paired = set(batched) | set(batched.values())
        params = [p for k, f in enumerate(program.fields)
                  for p in ([f"{T}* in{k}", f"{T}* alt{k}"] if f in paired
                            else [f"const {T}* __restrict__ in{k}"])]
        params += [f"float* __restrict__ part{k}" for k in range(n_red)]
        params += ["const float* __restrict__ prm", "const bool* __restrict__ live",
                   "const bool* __restrict__ odd", "const int flip"]
    params += [f"const int64_t {n}" for n in (*dims, *strides, "xc")]
    w(f"__global__ void __launch_bounds__(kThreads, {shape.min_blocks}) stencil_kernel(")
    w("    " + ",\n    ".join(params) + ") {")
    tiles = [stage_tile(program, s, shape) for s in stages]
    if pipe:
        w("  extern __shared__ float smem[];")
        offset = 0
        for k, (s, (py, pz)) in enumerate(zip(stages, tiles)):
            w(f"  // stage {k}: footprint {s.footprint}, {op_count(s.ops)} operations")
            w(f"  float (*const sm{k})[{py * pz}] = reinterpret_cast<float (*)[{py * pz}]>("
              f"smem + {offset});  // kSlots x {py} x {pz}")
            offset += py * pz * queue_planes(program, shape)
        for q in queues:
            w(f"  // field {q.field}: cells {q.lo} to {q.hi} around a core cell")
            w(f"  float (*const smf{q.index})[{q.words}] = reinterpret_cast<float (*)[{q.words}]>("
              f"smem + {offset});  // {q.slots} x {q.rows} x {q.cols}, padded")
            offset += q.words * q.slots
        w("  // each output's step of planes, as stored, in two buffers: one written")
        w("  // while the other goes out")
        for k in range(n_out):
            w(f"  {T} (*const smo{k})[kPlanes][kOutRow] = reinterpret_cast<{T} (*)[kPlanes]"
              f"[kOutRow]>(smem + {offset});")
            offset += 2 * planes * out_row(shape)
    else:
        for k, (s, (py, pz)) in enumerate(zip(stages, tiles)):
            w(f"  // stage {k}: footprint {s.footprint}, {op_count(s.ops)} operations")
            w(f"  __shared__ float sm{k}[kSlots][{py * pz}];  // {py} x {pz} per plane")
        for f, box in fq.items():
            py, pz = field_tile(box, shape)
            w(f"  // field {f}: cells {box[0]} to {box[1]} around a core cell")
            w(f"  __shared__ float smf{fidx[f]}[kSlots][{py * pz}];  // {py} x {pz} per plane")
        if fq:
            w("  // each output's step of planes, as stored, written out planes-fastest")
            for k in range(n_out):
                w(f"  __shared__ {st.ctype} smo{k}[kPlanes][kThreads];")
    w("  const int tz = threadIdx.x, ty = threadIdx.y;")
    w("  const int tid = ty * kBlockZ + tz;")
    if batched is None:
        block_origin(w, program)
    else:
        _emit_sample(w, program, divs)
    w("  const int x1 = min(x0 + static_cast<int>(xc), static_cast<int>(nx));")
    w("  const int y = y0 + ty, z = z0 + tz;")
    for c, off in enumerate(classes):
        if any(off):
            w(f"  // shape class {c}: base extents less {off}")
        for ax, n, d in zip("xyz", dims, off):
            w(f"  const int m{c}{ax} = static_cast<int>({n})" + (f" - {d};" if d else ";"))
        _emit_strides(w, c, zs, sample=batched is not None)
    if batched is None:
        for f, k in fidx.items():
            w(f"  const {T}* __restrict__ g{k} = in{k} + b{fcls[f]};")
        for k, op in enumerate(program.outputs):
            w(f"  {T}* __restrict__ h{k} = out{k} + b{fcls[op.name]};")
    else:
        # an output's buffer is read (its ring) and written in place: no
        # __restrict__ on either pointer; a target is only read this launch
        for f, k in fidx.items():
            if f not in paired:
                w(f"  const {T}* __restrict__ g{k} = in{k} + b{fcls[f]};")
            else:
                restrict = "" if f in batched else " __restrict__"
                w(f"  const {T}*{restrict} g{k} = (par ? alt{k} : in{k}) + b{fcls[f]};")
        for k, op in enumerate(program.outputs):
            j = fidx[op.name]
            w(f"  {T}* const h{k} = (par ? alt{j} : in{j}) + b{fcls[op.name]};")
    _emit_core_box(w, program, fcls)
    w("  const bool in_grid = y < ny && z < nz;")
    w("  const bool yz_core = y >= cylo && y < cyhi && z >= czlo && z < czhi;")
    for k, (s, (py, pz)) in enumerate(zip(stages, tiles)):
        _emit_stage_setup(w, program, shape, k, s, py, pz, fcls)
    if pipe:
        _emit_copy_setup(w, queues, shape)
    for r in range(n_red):
        w(f"  float acc{r} = 0.0f;")
    if part:
        w("  float sink = 0.0f;  // what the timing variant drops")
    if queued and not pipe:
        w("  int base = 0;  // the queue slot of the first plane a step stages")
    first = f"x0{f' - {lead}' if lead else ''}"
    if pipe:
        if stages:
            w("  int base = 0;  // the stages' queue slot of the first plane a step stages")
        w("  // each field queue's slot of the first plane of the window a step reads")
        w("  int " + ", ".join(f"fb{q.index} = 0" for q in queues) + ";")
        w("  int cur = 0;  // the step buffer this step writes")
        w(f"  int xs = {first};")
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
        if part == "stage":
            for q in queues:
                w(f"    sink += smf{q.index}[{fslot(q.field, '(xs & (kPlanes - 1))')}][tid];")
        elif not part:
            w(f"    if (xs != {first}) {{  // the previous step's outputs")
            _emit_step_store(w, program, shape, fcls, "      ", "xs - kPlanes", "cur ^ 1")
            w("    }")
    else:
        w("  #pragma unroll 1")
        w(f"  for (int xs = {first}; xs < x1; xs += kPlanes) {{")
        for f, box in fq.items():
            _emit_field_queue(w, program, shape, f, box, fidx, fcls, st)
        if part:
            w("    __syncthreads();")
            for f in fq:
                w(f"    sink += smf{fidx[f]}[wrap(base + (xs & (kPlanes - 1)))][tid];")
    if part != "stage":
        if fq and stages and not pipe:
            w("    __syncthreads();")
        for k, (s, (py, pz)) in enumerate(zip(stages, tiles)):
            _emit_stage(w, program, shape, k, s, py, pz, fidx, fcls, st, fq, fslot, ahead,
                        loads_only=part == "load")
        if stages or (fq and not pipe):
            w("    __syncthreads();")
        out_idx = {op.name: k for k, op in enumerate(program.outputs)}

        def operand(f):
            # a reduction's operand at the cell: an output's value, else the
            # field's (from its queue where an async slab holds the cell)
            if f in out_idx:
                return f"v{out_idx[f]}"
            if pipe and f in fq and all(l <= 0 <= h for l, h in zip(*fq[f])):
                (flo, fhi), (_, fpz) = fq[f], field_tile(fq[f], shape)
                return (f"smf{fidx[f]}[{fslot(f, f'(x - xs) - {ahead[f]}')}]"
                        f"[(ty - {flo[1]}) * {fpz} + tz - {flo[2]}]")
            return st.widen(f"g{fidx[f]}[at{fcls[f]}]")

        reds = [fold_line(r, red, [operand(f) for f in red.operands])
                for r, (_, red) in enumerate(program.reductions)]
        # where a slab writes an output's value: its step buffer
        buf = (lambda k: f"smo{k}[cur][x - xs][tid]") if pipe else (lambda k: f"smo{k}[x - xs][tid]")
        # the core program at plane x
        w("    auto core = [&](const int x) {")
        ind = "      "
        for c in range(len(classes)):
            w(f"{ind}const int at{c} = (x - x0) * S{c}x + ty * S{c}y + {_zs('tz', c, zs)};")
        for d in sorted({program.to3(rel, 0)[0] for _, rel in core.reads}):
            w(f"{ind}const int q{d - lo_x} = wrap(base + (x - xs) + {d - hi_x});")
        for j, (f, off) in enumerate(core.loads):
            c = fcls[f]
            if f in fq:
                (flo, fhi), (_, fpz) = fq[f], field_tile(fq[f], shape)
                d = program.to3(off, 0)
                w(f"{ind}const float l{j} = smf{fidx[f]}[{fslot(f, f'(x - xs) + {d[0] - ahead[f]}')}]"
                  f"[(ty + {d[1] - flo[1]}) * {fpz} + tz + {d[2] - flo[2]}];")
                continue
            w(f"{ind}const float l{j} = "
              f"{st.widen(f'g{fidx[f]}[{_offset(f"at{c}", c, program.to3(off, 0), "S", zs)}]')};")
        for j, (k, rel) in enumerate(core.reads if part != "load" else ()):
            d, lo = program.to3(rel, 0), program.to3(stages[k].lo, 0)
            pz = tiles[k][1]
            w(f"{ind}const float u{j} = sm{k}[q{d[0] - lo_x}][(ty + {d[1] - lo[1]}) * {pz} + tz + {d[2] - lo[2]}];")
        ref = _printer("l", "u", "e")
        if part == "load":
            w(f"{ind}sink += {' + '.join(f'l{j}' for j in range(len(core.loads)))};")
        else:
            _emit_ops(w, ind, core.ops, "e", ref)
        for k, (op, res) in enumerate(zip(program.outputs, core.results)):
            if part == "load":
                continue
            val = emit_value(w, ind, k, ref(res), st)
            if part == "compute" and not fq:
                w(f"{ind}sink += v{k};")
                continue
            w(f"{ind}" + (f"{buf(k)} = {val};" if fq else f"h{k}[at{fcls[op.name]}] = {val};"))
        for line in reds if part != "load" else ():
            w(f"{ind}{line}")
        w("    };")
        # every output's direct program at plane x: rings, faces and the edges
        # of staggered extents
        w("    auto direct = [&](const int x) {")
        for c in range(len(classes)):
            w(f"{ind}const int at{c} = (x - x0) * S{c}x + ty * S{c}y + {_zs('tz', c, zs)};")
        for k in range(n_out):
            w(f"{ind}float v{k};")
        _emit_direct(w, program, fidx, fcls, st=st,
                     store=(lambda k, op, val: f"{buf(k)} = {val};") if fq else None)
        for line in reds:
            w(f"{ind}{line}")
        w("    };")
        w("    if (in_grid) {")
        w("      if (yz_core && xs >= x0 && xs >= cxlo && xs + kPlanes <= x1 && xs + kPlanes <= cxhi) {")
        w("        #pragma unroll")
        w("        for (int p = 0; p < kPlanes; ++p) core(xs + p);")
        w("      } else {")
        w("        #pragma unroll 1")
        w("        for (int x = max(xs, x0); x < min(xs + kPlanes, x1); ++x) {")
        w("          if (yz_core && x >= cxlo && x < cxhi) core(x); else direct(x);")
        w("        }")
        w("      }")
        w("    }")
        if part == "compute" and fq:
            if not pipe:
                w("    __syncthreads();")
            for k in range(n_out):
                sub = "[cur]" if pipe else ""
                w(f"    sink += {st.widen(f'smo{k}{sub}[xs & (kPlanes - 1)][tid]')};")
        elif fq and not pipe:
            _emit_slab_store(w, program, fidx, fcls)
    if pipe:
        for q in queues:
            w(f"    fb{q.index} = ring(fb{q.index} + kPlanes, {q.slots});")
        w("    cur ^= 1;")
        if stages:
            w("    base = wrap(base + kPlanes);")
    elif queued:
        w("    base = wrap(base + kPlanes);")
    w("  }")
    if pipe and not part:
        w("  __syncthreads();  // the last step's outputs")
        _emit_step_store(w, program, shape, fcls, "  ", "xs - kPlanes", "cur ^ 1")
    if part:
        w(f"  if (sink == 1.0e38f) h0[0] = {st.narrow('sink')};")
    emit_block_fold(w, program)
    w("}")
    w("")
    w("}  // namespace")
    w("")
    _emit_entry(w, program, st, pipe, batched)
    return "\n".join(lines) + "\n"


def emit_block_fold(w, program: TapProgram) -> None:
    """Fold each reduction's ``acc{r}`` over the block into its partial."""
    n_red = len(program.reductions)
    if not n_red:
        return
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


def _emit_entry(w, program: TapProgram, st: Storage, pipe: bool,
                batched: Mapping[str, str] | None = None) -> None:
    """The plain C entry point ``launch`` and ``error_string`` (with
    ``batched``, the batched kernel's: each paired field's two buffers,
    the partials, the scalars' array, the live and parity flags, the
    launch's flip, then ``nb`` samples after the grid)."""
    n_out, n_red, n_par = len(program.outputs), len(program.reductions), len(program.params)
    divs = divisor_params(program)
    dims = ("nx", "ny", "nz")
    strides = stride_names(program)
    T = st.ctype
    if batched is None:
        cargs = [f"const void* in{k}" for k in range(len(program.fields))]
        cargs += [f"void* out{k}" for k in range(n_out)]
        cargs += [f"void* part{k}" for k in range(n_red)]
        cargs += [f"float p{k}" for k in range(n_par)] + [f"float r{k}" for k in divs]
        cargs += [f"int64_t {n}" for n in (*dims, *strides, "xc", "gz", "gy", "gx")]
    else:
        paired = set(batched) | set(batched.values())
        cargs = [a for k, f in enumerate(program.fields)
                 for a in ([f"void* in{k}", f"void* alt{k}"] if f in paired
                           else [f"const void* in{k}"])]
        cargs += [f"void* part{k}" for k in range(n_red)]
        cargs += ["const void* prm", "const void* live", "const void* odd", "int flip"]
        cargs += [f"int64_t {n}" for n in (*dims, *strides, "xc", "gz", "gy", "gx", "nb")]
    cargs += ["void* stream"]
    w('extern "C" int launch(' + ", ".join(cargs) + ") {")
    if batched is None:
        w(f"  const dim3 grid({grid_dims(program)});")
    else:
        w("  if (gx * nb > 65535) return static_cast<int>(cudaErrorInvalidValue);")
        w("  const dim3 grid(static_cast<unsigned>(gz), static_cast<unsigned>(gy), "
          "static_cast<unsigned>(gx * nb));")
    w("  const dim3 block(kBlockZ, kBlockY, 1);")
    if pipe:
        w("  const cudaError_t set = cudaFuncSetAttribute(")
        w("      stencil_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kShared);")
        w("  if (set != cudaSuccess) return static_cast<int>(set);")
    if batched is None:
        kargs = [f"static_cast<const {T}*>(in{k})" for k in range(len(program.fields))]
        kargs += [f"static_cast<{T}*>(out{k})" for k in range(n_out)]
        kargs += [f"static_cast<float*>(part{k})" for k in range(n_red)]
        kargs += [f"p{k}" for k in range(n_par)] + [f"r{k}" for k in divs]
    else:
        kargs = [a for k, f in enumerate(program.fields)
                 for a in ([f"static_cast<{T}*>(in{k})", f"static_cast<{T}*>(alt{k})"]
                           if f in paired else [f"static_cast<const {T}*>(in{k})"])]
        kargs += [f"static_cast<float*>(part{k})" for k in range(n_red)]
        kargs += ["static_cast<const float*>(prm)", "static_cast<const bool*>(live)",
                  "static_cast<const bool*>(odd)", "flip"]
    kargs += [*dims, *strides, "xc"]
    w(f"  stencil_kernel<<<grid, block, {'kShared' if pipe else 0}, "
      "static_cast<cudaStream_t>(stream)>>>(")
    w("      " + ", ".join(kargs) + ");")
    w("  return static_cast<int>(cudaGetLastError());")
    w("}")
    w("")
    w('extern "C" const char* error_string(int err) {')
    w("  return cudaGetErrorString(static_cast<cudaError_t>(err));")
    w("}")


def emit_value(w, ind: str, k: int, expr: str, st: Storage) -> str:
    """Print output ``k``'s value ``v{k}`` at a cell: for f32 storage the
    computed value; else the value rounded to storage (``n{k}``) and
    ``v{k}`` widened from it, the value a reduction folds. Returns the
    name of the value to store."""
    if st.wide:
        w(f"{ind}const float v{k} = {expr};")
        return f"v{k}"
    w(f"{ind}const {st.ctype} n{k} = {st.narrow(expr)};")
    w(f"{ind}const float v{k} = {st.widen(f'n{k}')};")
    return f"n{k}"


def _emit_core_box(w, program: TapProgram, fcls) -> None:
    """``c{x,y,z}lo``/``hi``: the core, where every output is written by its
    update, inside its extent, off its faces."""
    axes3 = program.axes3
    box_lo, box_hi = [{0} for _ in range(3)], [[] for _ in range(3)]
    for op in program.outputs:
        co = fcls[op.name]
        bc_axes = {axes3[a] for a in op.bc.resolved_axes(program.ndim)} if op.bc else set()
        for a, r in enumerate(program.to3(op.rings, 0)):
            d = max(r, op.bc.depth if a in bc_axes else 0)
            box_lo[a].add(d)
            box_hi[a].append(f"m{co}{'xyz'[a]}" + (f" - {d}" if d else ""))
    for a, ax in enumerate("xyz"):
        hi_e = ""
        for t in dict.fromkeys(box_hi[a]):
            hi_e = f"min({hi_e}, {t})" if hi_e else t
        w(f"  const int c{ax}lo = {max(box_lo[a])}, c{ax}hi = {hi_e};")


def _emit_stage_setup(w, program: TapProgram, shape: KernelShape, k: int, s: Stage, py: int,
                      pz: int, fcls) -> None:
    """The fixed (y, z) elements each thread stages for stage ``k``, every
    plane: their frame test and their offsets in each shape class, taken
    at the nearest element inside the frame."""
    nt = shape.threads
    lo, trim = program.to3(s.lo, 0), program.to3(s.trim, 0)
    n = py * pz
    for i in range(-(-n // nt)):
        e = f"tid + {i * nt}" if i else "tid"
        w(f"  const int e{k}_{i} = {e};")
        ey = f"y0 + {lo[1]} + e{k}_{i} / {pz}" if py > 1 else f"y0 + {lo[1]}"
        w(f"  const int ey{k}_{i} = min(max({ey}, 0), static_cast<int>(ny) - {trim[1] + 1});")
        w(f"  const int ez{k}_{i} = min(max(z0 + {lo[2]} + e{k}_{i} % {pz}, 0), "
          f"static_cast<int>(nz) - {trim[2] + 1});")
        inside = [f"ey{k}_{i} == {ey}", f"ez{k}_{i} == z0 + {lo[2]} + e{k}_{i} % {pz}"]
        if (i + 1) * nt > n:
            inside.insert(0, f"e{k}_{i} < {n}")
        w(f"  const bool in{k}_{i} = {' && '.join(inside)};")
        if shape.slab:
            # the element's place in the block (unclamped): its field queue row and column
            w(f"  const int ry{k}_{i} = {lo[1]}" + (f" + e{k}_{i} / {pz};" if py > 1 else ";"))
            w(f"  const int rz{k}_{i} = {lo[2]} + e{k}_{i} % {pz};")
            continue
        for c in sorted({fcls[f] for f, _ in s.loads}):
            w(f"  const int o{k}_{i}_{c} = (ey{k}_{i} - y0) * S{c}y + "
              f"{_zs(f'(ez{k}_{i} - z0)', c, program.z_strided)};")


def _emit_stage(w, program: TapProgram, shape: KernelShape, k: int, s: Stage, py: int, pz: int,
                fidx, fcls, st: Storage, fq=None, fslot=None, ahead=None,
                loads_only: bool = False) -> None:
    """Stage ``k``'s planes ``xs + kHi .. + kPlanes - 1`` over its tile and
    halo. An element outside the frame is computed at the nearest element
    inside (so every load is in range and none waits on a branch) and
    stored as 0. A slab's stage reads the field queues ``fq`` (``fslot``:
    the slot of a plane from the first of a step's window, each window
    ``ahead`` of the step). ``loads_only`` (a timing variant) folds the
    loads into ``sink`` and computes and stages nothing."""
    nt = shape.threads
    n = py * pz
    trim_x = program.to3(s.trim, 0)[0]
    w(f"    // stage {k}")
    w("    #pragma unroll")
    w("    for (int p = 0; p < kPlanes; ++p) {")
    w("      const int q = xs + kHi + p;")
    w(f"      const int qc = min(max(q, 0), static_cast<int>(nx) - {trim_x + 1});")
    if not loads_only:
        w(f"      float* const dst = sm{k}[wrap(base + p)];")
    for i in range(-(-n // nt)):
        ind = "      "
        if (i + 1) * nt > n:
            w(f"      if (e{k}_{i} < {n}) {{")
            ind += "  "
        else:
            w("      {")
            ind += "  "
        if not fq:
            for c in sorted({fcls[f] for f, _ in s.loads}):
                w(f"{ind}const int e{c} = (qc - x0) * S{c}x + o{k}_{i}_{c};")
        hi_x = march_reach(program)[1]
        for j, (f, off) in enumerate(s.loads):
            c = fcls[f]
            d = program.to3(off, 0)
            if fq:
                # from the field's queue; an element outside the frame (its
                # value stored as 0) reads a cell clamped into the queue
                (flo, fhi), (fpy, fpz) = fq[f], field_tile(fq[f], shape)
                row = f"min(max(ry{k}_{i} + {d[1] - flo[1]}, 0), {fpy - 1})"
                col = f"min(max(rz{k}_{i} + {d[2] - flo[2]}, 0), {fpz - 1})"
                w(f"{ind}const float a{j} = smf{fidx[f]}[{fslot(f, f'p + {hi_x + d[0] - ahead[f]}')}]"
                  f"[{row} * {fpz} + {col}];")
                continue
            w(f"{ind}const float a{j} = "
              f"{st.widen(f'g{fidx[f]}[{_offset(f"e{c}", c, d, "S", program.z_strided)}]')};")
        if loads_only:
            w(f"{ind}sink += {' + '.join(f'a{j}' for j in range(len(s.loads)))};")
            w("      }")
            continue
        ref = _printer("a", "?", "t")
        _emit_ops(w, ind, s.ops, "t", ref)
        w(f"{ind}dst[e{k}_{i}] = q == qc && in{k}_{i} ? {ref(s.result)} : 0.0f;")
        w("      }")
    w("    }")


def _emit_slab_store(w, program: TapProgram, fidx, fcls) -> None:
    """A slab kernel's stores: after a barrier, each output's step of
    planes from shared memory to device memory, each thread taking one
    (plane, cell) pair with the planes fastest (coalesced along the
    contiguous x), within the chunk and the output's own extent."""
    w("    __syncthreads();")
    w("    for (int i = tid; i < kPlanes * kThreads; i += kThreads) {")
    w("      const int p = i % kPlanes, e = i / kPlanes;")
    w("      const int x = xs + p, y = y0 + e / kBlockZ, z = z0 + e % kBlockZ;")
    w("      if (x < x0 || x >= x1) continue;")
    for k, op in enumerate(program.outputs):
        c = fcls[op.name]
        w(f"      if (x < m{c}x && y < m{c}y && z < m{c}z) "
          f"h{k}[(x - x0) * S{c}x + (y - y0) * S{c}y + (z - z0) * S{c}z] = smo{k}[p][e];")
    w("    }")


def _emit_field_queue(w, program: TapProgram, shape: KernelShape, f: str, box, fidx, fcls,
                      st: Storage) -> None:
    """A slab kernel's field ``f``: its planes ``xs + hi .. + kPlanes - 1``
    over its queue's rows and columns, widened to f32, each thread taking
    one (plane, cell) pair with the planes fastest, so consecutive lanes
    read consecutive words of the contiguous axis; a cell outside the
    field's frame is read clamped into it and stored as 0 (no written cell
    reads it). (Keeping one plane per thread with the loop unrolled spilled
    and ran slower on the H100, PERF.md.)"""
    (lo, hi), (py, pz) = box, field_tile(box, shape)
    k, c = fidx[f], fcls[f]
    n = py * pz
    w(f"    // field {f}: planes xs + {hi[0]} on, {py} x {pz} cells each, planes fastest")
    w(f"    for (int i = tid; i < kPlanes * {n}; i += kThreads) {{")
    w("      const int p = i % kPlanes, e = i / kPlanes;")
    w(f"      const int q = xs + {hi[0]} + p;")
    w(f"      const int qc = min(max(q, 0), m{c}x - 1);")
    ey = f"y0 + {lo[1]} + e / {pz}" if py > 1 else f"y0 + {lo[1]}"
    w(f"      const int ey = {ey}, ez = z0 + {lo[2]} + e % {pz};")
    w(f"      const int eyc = min(max(ey, 0), m{c}y - 1), ezc = min(max(ez, 0), m{c}z - 1);")
    at = f"(qc - x0) * S{c}x + (eyc - y0) * S{c}y + (ezc - z0) * S{c}z"
    w(f"      const float v = {st.widen(f'g{k}[{at}]')};")
    w(f"      smf{k}[wrap(base + p)][e] = q == qc && ey == eyc && ez == ezc ? v : 0.0f;")
    w("    }")


@dataclasses.dataclass(frozen=True)
class FieldQueue:
    """A field's plane queue in an async slab's shared memory (``smf{index}``):
    the cells ``lo..hi`` (kernel axes) around each cell the block computes,
    ``rows`` x ``cols`` of them a plane over the block's tile, ``words``
    a plane with its pad, ``slots`` planes in its ring (``fb{index}``: the
    slot of the first plane of the window a step reads). Its class ``cls``
    gives its extents and strides."""

    field: str
    index: int
    cls: int
    lo: tuple[int, int, int]
    hi: tuple[int, int, int]
    rows: int
    cols: int
    words: int
    slots: int

    @property
    def ahead(self) -> int:
        """How far ahead of a step's first plane its copies begin: the
        queue's reach ahead, rounded up to :data:`ALIGN` planes."""
        return aligned(self.hi[0])


def aligned(planes: int) -> int:
    """``planes`` rounded up to a multiple of :data:`ALIGN`."""
    return -(-planes // ALIGN) * ALIGN


def slab_queues(boxes, shape: KernelShape, fidx, fcls) -> list[FieldQueue]:
    """The :class:`FieldQueue` of each field of ``boxes`` (``{field: (lo,
    hi)}``, :func:`field_queues`)."""
    out = []
    for f, (lo, hi) in boxes.items():
        rows, cols = field_tile((lo, hi), shape)
        if rows > 64 or -(-cols // (shape.threads // shape.planes)) > 64:
            raise LayoutRefused(f"field {f}'s queue of {rows} x {cols} cells a plane is "
                                      "wider than a copy's 64-bit masks")
        out.append(FieldQueue(f, fidx[f], fcls[f], tuple(lo), tuple(hi), rows, cols,
                              plane_words(rows * cols, shape.planes),
                              ring_planes((lo, hi), shape.planes)))
    return out


def ring_helper() -> list[str]:
    """The slot ``s`` of a ring of ``n`` planes, ``s`` in ``(-n, 2n)``."""
    return ["__device__ __forceinline__ int ring(int s, int n) {",
            "  return s < 0 ? s + n : s >= n ? s - n : s;",
            "}"]


def copy_helpers(st: Storage) -> list[str]:
    """The device functions an async slab's copies go through, between
    the markers that ``kernels/rehearse.py`` replaces with its stand-ins:
    ``copy_async`` (for f32 a 4-byte ``cp.async`` that reads nothing and
    zero-fills where not ``valid``; a 2-byte value is widened on its way
    into the f32 queue, so its copy is a load and a store),
    ``commit_copies`` and ``wait_copies`` (every copy of the thread
    landed)."""
    out = ["// copies: begin"]
    if st.wide:
        out += ["__device__ __forceinline__ void copy_async(float* dst, const float* src, "
                "bool valid) {",
                "  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));",
                '  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\\n" ::"r"(s), '
                '"l"(src),',
                '               "r"(valid ? 4 : 0) : "memory");',
                "}"]
    else:
        out += [f"__device__ __forceinline__ void copy_async(float* dst, const {st.ctype}* src, "
                "bool valid) {",
                "  *dst = valid ? widen(*src) : 0.0f;",
                "}"]
    out += ["__device__ __forceinline__ void commit_copies() {",
            '  asm volatile("cp.async.commit_group;\\n" ::: "memory");',
            "}",
            "__device__ __forceinline__ void wait_copies() {",
            '  asm volatile("cp.async.wait_group 0;\\n" ::: "memory");',
            "}",
            "// copies: end"]
    return out


def _emit_copy_setup(w, queues: Sequence[FieldQueue], shape: KernelShape) -> None:
    """Before the march, what a thread's copies keep for every step: its
    plane of a step and its column group (planes fastest, so a warp reads
    ``32 // planes`` runs of the contiguous axis), and per queue the offset
    of its first cell from the block's base and the masks of the rows and
    columns that lie inside the field's frame."""
    G = shape.threads // shape.planes
    w("  const int cp_p = tid % kPlanes, cp_g = tid / kPlanes;  // a copy's plane, column group")
    for q in queues:
        k, c, (_, ly, lz) = q.index, q.cls, q.lo
        w(f"  // field {q.field}: columns cp_g + kGroups j of its {q.rows} x {q.cols} cells")
        w(f"  const int fo{k} = {ly} * S{c}y + (cp_g + {lz}) * S{c}z;")
        w(f"  uint64_t rm{k} = 0, cm{k} = 0;")
        w(f"  for (int r = 0; r < {q.rows}; ++r) rm{k} |= uint64_t(y0 + {ly} + r >= 0 && "
          f"y0 + {ly} + r < m{c}y) << r;")
        w(f"  for (int j = 0; j < {-(-q.cols // G)}; ++j) {{")
        w(f"    const int zj = z0 + {lz} + cp_g + kGroups * j;")
        w(f"    cm{k} |= uint64_t(zj >= 0 && zj < m{c}z) << j;")
        w("  }")


def _emit_copies(w, queues: Sequence[FieldQueue], shape: KernelShape, st: Storage, ind: str,
                 xs: str, slot: str, behind: bool = False) -> None:
    """Issue the copies of the step of planes that begins at plane ``xs``:
    each field queue's window of ``kPlanes`` planes from ``xs`` + its
    ``ahead`` into its slots from ``slot`` (``{b}`` stands for the queue's
    base, ``fb{index}``), each thread its plane of every
    row at its columns (``behind``: the planes from its reach behind
    ``xs`` up to the window, which a chunk's first step reads). A cell
    outside the field's frame, or a plane the chunk does not read, is
    zero-filled and read from nowhere. The rows go by in a loop unrolled by
    two: unrolled fully, ptxas kept every row's offset in a register (168
    registers for FIG1 on the H100), not at all, the loop's own arithmetic
    showed (PERF.md, section 6)."""
    G = shape.threads // shape.planes
    for q in queues:
        k, c, lo = q.index, q.cls, q.lo[0]
        if behind and q.ahead <= lo:
            continue
        w(f"{ind}{{  // field {q.field}" + (", the planes behind" if behind else ""))
        sub = ind + "  "
        if behind:
            w(f"{sub}for (int q = {xs} + {lo} + cp_p; q < {xs} + {q.ahead}; q += kPlanes) {{")
            sub += "  "
            at = f"{slot.format(b=f'fb{k}')} + q - ({xs}) - {q.ahead}"
        else:
            w(f"{sub}const int q = {xs} + {q.ahead} + cp_p;")
            at = f"{slot.format(b=f'fb{k}')} + cp_p"
        w(f"{sub}const uint64_t vm = q >= 0 && q < min(m{c}x, x1 + {q.hi[0]}) ? rm{k} : 0;")
        w(f"{sub}const {st.ctype}* src = g{k} + (q - x0) * S{c}x + fo{k};")
        w(f"{sub}float* dst = &smf{k}[ring({at}, {q.slots})][cp_g];")
        w(f"{sub}#pragma unroll 2")
        w(f"{sub}for (int r = 0; r < {q.rows}; ++r, src += S{c}y, dst += {q.cols}) {{")
        w(f"{sub}  const bool vr = (vm >> r) & 1;")
        for j in range(-(-q.cols // G)):
            inner = sub + "  "
            partial = G * (j + 1) > q.cols
            if partial:
                w(f"{inner}if (cp_g < {q.cols - G * j}) {{")
                inner += "  "
            src = f"src + {G * j} * S{c}z" if j else "src"
            w(f"{inner}const bool v{j} = vr && ((cm{k} >> {j}) & 1);")
            w(f"{inner}copy_async(dst{f' + {G * j}' if j else ''}, v{j} ? {src} : g{k}, v{j});")
            if partial:
                w(f"{sub}  }}")
        w(f"{sub}}}")
        if behind:
            w(f"{ind}  }}")
        w(f"{ind}}}")


def _emit_step_store(w, program: TapProgram, shape: KernelShape, fcls, ind: str, xp: str,
                     buf: str) -> None:
    """Store each output's step of planes that begins at plane ``xp`` from
    step buffer ``buf``: each thread takes the copies' plane ``cp_p`` of
    cells ``cp_g + kGroups j``, planes fastest (coalesced along the
    contiguous x), within the chunk and the output's own extent; four cells
    at a time, so their shared-memory reads are in flight together."""
    w(f"{ind}{{")
    w(f"{ind}  const int x = {xp} + cp_p;")
    used = sorted({fcls[op.name] for op in program.outputs})
    for c in used:
        w(f"{ind}  const bool xv{c} = x >= x0 && x < x1 && x < m{c}x;")
    w(f"{ind}  #pragma unroll 4")
    w(f"{ind}  for (int e = cp_g; e < kThreads; e += kGroups) {{")
    w(f"{ind}    const int ey = e / kBlockZ, ez = e % kBlockZ;")
    for k, op in enumerate(program.outputs):
        c = fcls[op.name]
        w(f"{ind}    if (xv{c} && y0 + ey < m{c}y && z0 + ez < m{c}z) "
          f"h{k}[(x - x0) * S{c}x + ey * S{c}y + ez * S{c}z] = smo{k}[{buf}][cp_p][e];")
    w(f"{ind}  }}")
    w(f"{ind}}}")


def _emit_direct(w, program: TapProgram, fidx, fcls, access=None, prev=None,
                 store=None, st: Storage = _STORAGES[torch.float32],
                 in_place: bool = False) -> None:
    """Each output's direct program at a cell (x, y, z) outside the core.
    By default (the single-step kernel) its loads are indexed from the
    block's base (``at{class}``; a source cell across the domain in 64
    bits), its previous value is the output's own and it is stored to the
    output. The k-step kernel passes ``access(field, coords, off)`` (the
    tap ``off`` of a field at the cell ``coords``, three C expressions, its
    value in f32), ``prev(op, coords)`` and ``store(k, op, value)``. The
    value ``v{k}`` is rounded to storage ``st`` before it is stored and
    folded. ``in_place`` (each output written into the buffer it reads its
    previous value from, the batched column march): a cell that keeps its
    own previous value is not stored, so it keeps its bits, and is loaded
    only where a reduction folds it."""
    axes3 = program.axes3
    zs = program.z_strided
    ref = _printer("l", "?", "e")
    folded = {f for _, red in program.reductions for f in red.operands}
    for k, op in enumerate(program.outputs):
        co = fcls[op.name]
        modes, rings = program.to3(op.modes, "all"), program.to3(op.rings, 0)
        bc = op.bc
        bc_axes = sorted({axes3[a] for a in bc.resolved_axes(program.ndim)}) if bc else []
        mapped = bc is not None and bc.kind != "dirichlet"
        coords = tuple(f"{ax}{k}" for ax in "XYZ") if mapped else ("x", "y", "z")
        staggered = any(program.offsets[fidx[op.name]])
        ind = "      "
        if staggered:
            w(f"{ind}if (x < m{co}x && y < m{co}y && z < m{co}z) {{  // its own extent")
            ind += "  "
        if in_place:
            w(f"{ind}bool keep{k} = false;  // the cell keeps its own value: no store")
        w(f"{ind}{{  // output {op.name}" + (f", bc {bc.kind}" if bc else ""))
        body = ind + "  "
        ctype = "int64_t" if access is None else "int"
        if mapped:
            # the source cell, axis by axis (neumann0: one face depth
            # inward; periodic: across the domain)
            for ax, X in zip("xyz", coords):
                w(f"{body}{ctype} {X} = {ax};")
            for a in bc_axes:
                X, m, d = coords[a], f"m{co}{'xyz'[a]}", bc.depth
                shift = f"{d}" if bc.kind == "neumann0" else f"({m} - {2 * d})"
                w(f"{body}if ({X} < {d}) {X} += {shift}; "
                  f"else if ({X} >= {m} - {d}) {X} -= {shift};")
            if access is None:
                used = sorted({fcls[f] for f, _ in op.loads} | {co})
                rel = (f"({coords[0]} - x0)", f"({coords[1]} - y0)", f"({coords[2]} - z0)")
                for c in used:
                    w(f"{body}const int64_t j{k}_{c} = {_index(rel, c, zs)};")
        if access is None:
            base = (lambda c: f"j{k}_{c}") if mapped else (lambda c: f"at{c}")

            def tap(f, off, base=base):
                c = fcls[f]
                return st.widen(f"g{fidx[f]}[{_offset(base(c), c, off, zs=zs)}]")

            before = st.widen(f"g{fidx[op.name]}[{base(co)}]")
        else:
            def tap(f, off, coords=coords):
                return access(f, coords, off)

            before = prev(op, coords)
        conds = [f"{X} >= {r} && {X} < m{co}{ax} - {r}"
                 for X, ax, m, r in zip(coords, "xyz", modes, rings) if m == "inn" and r]
        if bc is not None and bc.kind == "dirichlet":
            faces = [f"{X} < {bc.depth} || {X} >= m{co}{'xyz'[a]} - {bc.depth}"
                     for a in bc_axes for X in [coords[a]]]
            w(f"{body}if ({' || '.join(faces)}) {{")
            w(f"{body}  v{k} = {float_literal(stored_value(bc.value, st.dtype))};")
            w(f"{body}}} else if ({' && '.join(conds) if conds else 'true'}) {{")
        else:
            w(f"{body}if ({' && '.join(conds) if conds else 'true'}) {{")
        inner = body + "  "
        for j, (f, off) in enumerate(op.loads):
            w(f"{inner}const float l{j} = {tap(f, program.to3(off, 0))};")
        _emit_ops(w, inner, op.ops, "e", ref)
        w(f"{inner}v{k} = {st.rounded(ref(op.result))};")
        w(f"{body}}} else {{")
        if not in_place:
            w(f"{inner}v{k} = {before};")
        else:
            keep = f"keep{k} = true;" + (f" v{k} = {before};" if op.name in folded else "")
            if mapped:
                same = " && ".join(f"{X} == {ax}" for X, ax in zip(coords, "xyz"))
                w(f"{inner}if ({same}) {{ {keep} }} else {{ v{k} = {before}; }}")
            else:
                w(f"{inner}{keep}")
        w(f"{body}}}")
        w(f"{ind}}}")
        val = st.narrow(f"v{k}")
        if in_place:
            w(f"{ind}if (!keep{k}) h{k}[at{co}] = {val};")
        else:
            w(f"{ind}" + (f"h{k}[at{co}] = {val};" if store is None else store(k, op, val)))
        if staggered:
            w("      }")
