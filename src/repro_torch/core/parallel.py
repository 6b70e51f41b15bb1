"""`@parallel`: single-source stencil kernels.

Usage, mirroring Fig. 1 of the paper::

    from repro_torch.core import init_parallel_stencil, fd3d as fd

    ps = init_parallel_stencil()              # backend="cuda", device="cuda"

    @ps.parallel(outputs=("T2",), rotations={"T2": "T"})
    def step(T2, T, Ci, lam, dt, _dx, _dy, _dz):
        return {"T2": fd.inn(T) + dt * (lam * fd.inn(Ci) * (
            fd.d2_xi(T) * _dx**2 + fd.d2_yi(T) * _dy**2 + fd.d2_zi(T) * _dz**2))}

    T2 = step(T2=T2, T=T, Ci=Ci, lam=lam, dt=dt, _dx=_dx, _dy=_dy, _dz=_dz)

The same kernel source runs on both backends:

  * ``backend="cuda"`` traces the update once with symbolic windows
    (``ir``), generates a CUDA kernel for it (``kernels.codegen``) and
    launches that; it needs the card;
  * ``backend="torch"`` evaluates the update on full tensors and writes it
    into a copy of the output (the plain path, on ``device="cpu"`` or the
    card).

Arguments are classified by value: tensors of the kernel's dimensionality
are fields, everything else is a scalar. Every name in ``outputs`` must be
a field argument; its previous contents provide the boundary values (the
paper's ``@inn(T2) = ...`` semantics). Outputs are new tensors.

Fields of one kernel may be staggered: a face-centred field is up to the
kernel's radius shorter than the cell-centred base along an axis, and an
output staggered along an axis is written at its full extent there (the
paper's ``@all(qx) = ...``). Boundary conditions are declared per output,
``bc={"T2": BoundaryCondition("neumann0"), ...}`` (or a bare kind string),
and hold after every step exactly as the ``core.boundary`` post-pass
applied after the write would: the ``torch`` backend applies that
post-pass, the generated CUDA kernel computes the face values inside its
launch.

``dtype`` is the fields' storage dtype: what they occupy in device memory
and what every call returns. bf16 and f16 storage compute in f32
(``compute_dtype``, by default ``kernels.stencil.default_compute_dtype``):
both backends cast each field up on load, run the update in f32 and round
each output to storage on store, and reductions fold the stored outputs
widened to ``acc_dtype`` (never narrower than f32). So a bf16 step moves
half the bytes of an f32 one, and its derivatives keep f32 precision.

``kernel.run_steps(k, **fields)`` advances k steps, each output rotating into
its ``rotations`` target: on ``backend="cuda"`` in one launch of a generated
k-step kernel (k launches for a periodic condition), on ``backend="torch"``
as k rotated single steps.

``march_axis=a`` (or ``kernel.marched(a)``) streams the update along axis
``a``: each thread of the generated kernel walks its column along that
axis, so the planes it has read stay on chip for its next steps
(ParallelStencil.jl's ``loopopt``; ``kernels/stencil.py`` says how the port
lays it out). Results do not depend on it: the ``torch`` backend computes a
marched kernel exactly as the all-parallel one, and the generated kernel is
bitwise equal to it. A field staggered along the march axis raises
``ValueError``; a march extent too short to fill the port's plane queue
launches the all-parallel kernel instead, and ``launch_info`` says so.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Mapping, Sequence

import torch

from .. import ir as _ir
from ..kernels import codegen, stencil as _stencil
from .device import on_device, resolve_device

_BACKENDS = ("cuda", "torch")


@dataclasses.dataclass(frozen=True)
class ParallelStencil:
    """Backend/dtype/ndims/device context (the paper's
    ``@init_parallel_stencil``). ``dtype`` is the storage dtype,
    ``compute_dtype`` (None: ``default_compute_dtype(dtype)``) what the
    update runs at."""

    backend: str = "cuda"
    dtype: torch.dtype = torch.float32
    ndims: int = 3
    device: Any = "cuda"
    compute_dtype: torch.dtype | None = None

    def __post_init__(self):
        if self.backend not in _BACKENDS:
            raise ValueError(f"backend must be one of {_BACKENDS}")
        cd = self.compute_dtype
        if cd is None:
            cd = _stencil.default_compute_dtype(self.dtype)
        # the port runs f32, bf16 and f16 storage, each computed in f32; the
        # reference also runs f64 storage under x64 and any compute named
        if self.dtype not in _stencil.STORAGE_DTYPES or cd != torch.float32:
            item = ("f64 storage" if torch.float64 in (self.dtype, cd)
                    else "compute narrower than f32")
            raise NotImplementedError(
                f"storage {self.dtype} with compute {cd} is not ported yet (ROADMAP "
                f"queue 1, item 3: {item}); the port runs f32, bf16 and f16 storage, "
                "each computed in f32"
            )
        object.__setattr__(self, "compute_dtype", cd)
        dev = resolve_device(self.device)
        if self.backend == "cuda" and dev.type != "cuda":
            raise ValueError(
                "backend='cuda' runs generated kernels on the card; use "
                "backend='torch' for device='cpu'"
            )
        object.__setattr__(self, "device", dev)

    @property
    def acc_dtype(self) -> torch.dtype:
        """The dtype reductions accumulate in (never narrower than f32)."""
        return _stencil.accum_dtype(self.compute_dtype)

    def parallel(
        self,
        outputs: Sequence[str],
        rotations: Mapping[str, str] | None = None,
        reductions: Mapping[str, Any] | None = None,
        bc: Mapping[str, Any] | None = None,
        march_axis: int | None = None,
    ) -> Callable[[Callable], "StencilKernel"]:
        """``rotations`` maps each output to the input it becomes on the next
        time step (``{"T2": "T"}``), as ``solve_until`` needs.
        ``reductions`` declares named in-launch reductions
        (``{"err": "max_abs_diff(T2, T)"}``): the call then returns
        ``(outputs, {name: 0-d tensor})``, each folded over the outputs
        after their boundary conditions. ``bc`` maps outputs to
        :class:`~repro_torch.ir.BoundaryCondition` or kind strings.
        ``march_axis`` streams the update along that axis (module
        docstring)."""
        march_axis = _check_march(march_axis, self.ndims)

        def deco(fn: Callable) -> StencilKernel:
            return StencilKernel(self, fn, tuple(outputs), rotations, reductions, bc,
                                 march_axis)

        return deco


def _check_march(march_axis, ndims: int) -> int | None:
    if march_axis is not None and not 0 <= int(march_axis) < ndims:
        raise ValueError(f"march_axis {march_axis} out of range for ndims={ndims}")
    return None if march_axis is None else int(march_axis)


def init_parallel_stencil(backend: str = "cuda", dtype: torch.dtype = torch.float32,
                          ndims: int = 3, device="cuda",
                          compute_dtype: torch.dtype | None = None) -> ParallelStencil:
    return ParallelStencil(backend=backend, dtype=dtype, ndims=ndims, device=device,
                           compute_dtype=compute_dtype)


class StencilKernel:
    """A stencil kernel, traced and (on ``backend="cuda"``) compiled on first
    use for each set of field shapes."""

    def __init__(self, ps: ParallelStencil, fn: Callable, outputs: tuple[str, ...],
                 rotations: Mapping[str, str] | None = None,
                 reductions: Mapping[str, Any] | None = None,
                 bc: Mapping[str, Any] | None = None,
                 march_axis: int | None = None):
        self.ps = ps
        self.fn = fn
        self.outputs = outputs
        self.rotations = dict(rotations) if rotations else None
        self.bc = _ir.normalize_bcs(bc, outputs, ps.ndims)
        self.reductions = _ir.normalize_reductions(reductions)
        self.march_axis = _check_march(march_axis, ps.ndims)
        if self.reductions and any(c.kind == "periodic" for c in self.bc.values()):
            # the port computes periodic faces inside its launch, but keeps the
            # reference's API, whose fold would see pre-wrap faces
            raise ValueError(
                "fused reductions cannot be declared next to a periodic "
                "boundary condition (as in the reference engine, whose wrap "
                "scatter runs after its launch)"
            )
        self._ir_cache: dict = {}
        self._calls: dict = {}
        self._red_variants: dict = {}
        self._dtype_variants: dict = {}
        self._march_variants: dict = {}
        functools.update_wrapper(self, fn)

    @property
    def label(self) -> str:
        name = getattr(self.fn, "__name__", "kernel")
        return f"{name}[{','.join(self.reductions)}]" if self.reductions else name

    def _variant(self, ps: ParallelStencil, reductions, march_axis) -> "StencilKernel":
        return StencilKernel(ps, self.fn, self.outputs, self.rotations, reductions, self.bc,
                             march_axis)

    def marched(self, march_axis: int | None) -> "StencilKernel":
        """A variant of this kernel streaming along ``march_axis`` (``None``:
        the all-parallel variant), with this kernel's reductions, dtype and
        backend. Memoized on this kernel, so each variant traces and builds
        once."""
        march_axis = _check_march(march_axis, self.ps.ndims)
        if march_axis == self.march_axis:
            return self
        v = self._march_variants.get(march_axis)
        if v is None:
            v = self._march_variants[march_axis] = self._variant(self.ps, self.reductions,
                                                                 march_axis)
        return v

    def with_reductions(self, reductions: Mapping[str, Any] | None) -> "StencilKernel":
        """A variant of this kernel with another fused-reduction set
        (``None`` strips them: the plain step ``solve_until`` runs between
        checks). Memoized, so each variant traces and builds once."""
        reds = _ir.normalize_reductions(reductions)
        if reds == self.reductions:
            return self
        key = tuple(sorted(reds.items()))
        v = self._red_variants.get(key)
        if v is None:
            v = self._red_variants[key] = self._variant(self.ps, reds, self.march_axis)
        return v

    def with_dtype(self, dtype: torch.dtype) -> "StencilKernel":
        """The same update with its fields stored as ``dtype`` (computed at
        ``default_compute_dtype(dtype)``), on this kernel's backend and
        device: how a solver that takes no storage dtype of its own runs at
        bf16 or f16. Memoized."""
        if dtype == self.ps.dtype:
            return self
        v = self._dtype_variants.get(dtype)
        if v is None:
            ps = dataclasses.replace(self.ps, dtype=dtype, compute_dtype=None)
            v = self._variant(ps, self.reductions, self.march_axis)
            self._dtype_variants[dtype] = v
        return v

    def apply_reductions(self, outs: Mapping[str, torch.Tensor],
                         fields: Mapping[str, torch.Tensor]) -> dict[str, torch.Tensor]:
        """Whole-tensor folds of this kernel's reductions over the new
        outputs and the pre-step fields (as stored), each widened to
        ``acc_dtype`` first: what a separate pass computes."""
        reds = {}
        acc = self.ps.acc_dtype
        for name, r in self.reductions.items():
            ops = [(outs[op] if op in outs else fields[op]).to(acc) for op in r.operands]
            reds[name] = r.fold(r.map_element(*ops))
        return reds

    # -- argument classification ------------------------------------------
    def _split(self, kwargs: Mapping[str, Any]):
        fields, scalars = {}, {}
        for name, v in kwargs.items():
            if isinstance(v, torch.Tensor) and v.dim() == self.ps.ndims:
                if not on_device(v, self.ps.device):
                    raise ValueError(
                        f"field {name!r} lies on {v.device}, but the kernel runs "
                        f"on {self.ps.device}; move it explicitly"
                    )
                # fields live at the storage dtype: cast once at the rim
                fields[name] = v.to(self.ps.dtype)
            elif getattr(v, "ndim", 0) == self.ps.ndims:
                raise TypeError(
                    f"field {name!r} is a {type(v).__name__}; pass torch tensors "
                    "(repro_torch.interop.fields_from_numpy converts numpy arrays)"
                )
            else:
                scalars[name] = v
        if not fields:
            raise ValueError("no field arguments found")
        for o in self.outputs:
            if o not in fields:
                raise ValueError(f"output {o!r} is not a field argument")
        return fields, scalars

    def _trace(self, shapes: Mapping[str, tuple], scalar_names: Sequence[str]) -> _ir.StencilIR:
        """Trace the update once per field-shape set."""
        key = (tuple(sorted(shapes.items())), tuple(sorted(scalar_names)))
        ir = self._ir_cache.get(key)
        if ir is None:
            def update(fdict, sdict):
                return self.fn(**fdict, **sdict)

            ir = _ir.trace_stencil(update, shapes, self.outputs, scalar_names,
                                   reductions=self.reductions)
            # face depths must fit the outputs' extents
            _ir.normalize_bcs(self.bc, self.outputs, self.ps.ndims, field_shapes=shapes)
            _stencil.unsupported(ir)
            _stencil.check_march(ir, self.march_axis)
            self._ir_cache[key] = ir
        return ir

    def stencil_ir(self, **kwargs) -> _ir.StencilIR:
        """The traced IR for a field set. Accepts the keyword arguments of a
        call: tensors or bare shape tuples for the fields (scalars may be
        given any value)."""
        shapes, scalar_names = {}, []
        for name, v in kwargs.items():
            if isinstance(v, (tuple, list)) and len(v) == self.ps.ndims \
                    and all(isinstance(x, int) for x in v):
                shapes[name] = tuple(v)
            elif isinstance(v, torch.Tensor) and v.dim() == self.ps.ndims:
                shapes[name] = tuple(v.shape)
            else:
                scalar_names.append(name)
        if not shapes:
            raise ValueError("no field shapes given")
        return self._trace(shapes, scalar_names)

    def cost_model(self, **kwargs) -> _ir.StencilCostModel:
        """The analytic flop and byte model of one launch for a field set
        (arguments as for :meth:`stencil_ir`): bytes at the storage
        itemsize, reduction partials at the accumulation width."""
        ir = self.stencil_ir(**kwargs)
        isz = self.ps.dtype.itemsize
        return _ir.StencilCostModel.from_ir(
            ir, isz, field_itemsizes=tuple(isz for _ in ir.field_shapes),
            partials_itemsize=self.ps.acc_dtype.itemsize)

    # -- backends -----------------------------------------------------------
    def _run_torch(self, fields, scalars, ir: _ir.StencilIR):
        # cast on load, compute at compute_dtype, round on store (the write
        # into the storage-dtype output rounds to nearest even); a marched
        # kernel computes exactly this: marching changes the launch, not the
        # values
        cd = self.ps.compute_dtype
        updates = self.fn(**{n: v.to(cd) for n, v in fields.items()}, **scalars)
        outs = {}
        for name in self.outputs:
            idx = tuple(slice(w, n - w) for w, n in
                        zip(ir.write_rings[name], fields[name].shape))
            out = fields[name].clone()
            out[idx] = updates[name]
            cond = self.bc.get(name)
            outs[name] = out if cond is None else cond.apply(out)
        reds = self.apply_reductions(outs, fields) if self.reductions else None
        return outs, reds

    def _call(self, ir: _ir.StencilIR, nsteps: int = 1) -> _stencil.StencilCall:
        key = (id(ir), nsteps)
        call = self._calls.get(key)
        if call is None:
            call = self._calls[key] = _stencil.StencilCall(
                ir, self.label, self.bc, nsteps=nsteps,
                rotations=self.rotations if nsteps > 1 else None, dtype=self.ps.dtype,
                march_axis=self.march_axis)
        return call

    def compiled(self, nsteps: int = 1, **kwargs) -> _stencil.StencilCall:
        """The generated kernel for a field set (arguments as for
        :meth:`stencil_ir`), sweeping ``nsteps`` times per launch; its
        ``source`` is what the build compiles."""
        nsteps = int(nsteps)
        if nsteps > 1:
            self.check_rotations(kwargs)
        return self._call(self.stencil_ir(**kwargs), nsteps)

    def _run_cuda(self, fields, scalars, ir: _ir.StencilIR):
        return self._call(ir).run(fields, scalars)

    def __call__(self, **kwargs):
        fields, scalars = self._split(kwargs)
        ir = self._trace({n: tuple(v.shape) for n, v in fields.items()}, tuple(scalars))
        run = self._run_cuda if self.ps.backend == "cuda" else self._run_torch
        outs, reds = run(fields, scalars, ir)
        res = outs[self.outputs[0]] if len(self.outputs) == 1 else outs
        return (res, reds) if self.reductions else res

    def run_steps(self, nsteps: int, **kwargs):
        """Advance ``nsteps`` time steps; returns the final outputs (the
        structure of ``__call__``, with the last step's reductions).

        ``backend="cuda"`` makes one launch of the generated k-step kernel
        (``kernels/codegen_steps.py``): each field crosses device memory once
        per ``nsteps`` steps, with the boundary conditions applied between
        sweeps as the post-pass applies them between steps. A periodic
        condition wraps across the whole domain, outside every block's
        window, so it runs as ``nsteps`` single-step launches instead, as the
        reference does. ``backend="torch"`` runs ``nsteps`` single steps with
        the ``rotations`` double-buffer rotation (the reference's ``jnp``
        path). Both equal ``nsteps`` rotated calls bitwise when each output
        and its rotation target agree on the write ring."""
        nsteps = int(nsteps)
        if nsteps < 1:
            raise ValueError(f"nsteps must be >= 1, got {nsteps}")
        if nsteps == 1:
            return self(**kwargs)
        fields, scalars = self._split(kwargs)
        self.check_rotations(fields)
        ir = self._trace({n: tuple(v.shape) for n, v in fields.items()}, tuple(scalars))
        periodic = any(c.kind == "periodic" for c in self.bc.values())
        if self.ps.backend == "cuda" and not periodic:
            outs, reds = self._call(ir, nsteps).run(fields, scalars)
        else:
            run = self._run_cuda if self.ps.backend == "cuda" else self._run_torch
            cur = dict(fields)
            for s in range(nsteps):
                outs, reds = run(cur, scalars, ir)
                if s < nsteps - 1:
                    for o, tgt in self.rotations.items():
                        cur[o], cur[tgt] = cur[tgt], outs[o]
        res = outs[self.outputs[0]] if len(self.outputs) == 1 else outs
        return (res, reds) if self.reductions else res

    def check_rotations(self, fields: Mapping[str, torch.Tensor]) -> None:
        """Every output rotates into a field of its own shape that is not an
        output (``ValueError`` otherwise): what k steps in one launch, and
        ``solve_until``'s double buffers, need. ``fields`` maps names to
        tensors or shape tuples."""
        if not self.rotations or set(self.outputs) - set(self.rotations):
            raise ValueError(
                "stepping more than once requires rotations covering every output "
                "(pass rotations={'T2': 'T'}-style mapping to @parallel)"
            )
        for o, tgt in self.rotations.items():
            if tgt not in fields:
                raise ValueError(f"rotation target {tgt!r} is not a field")
            if tgt in self.outputs:
                raise ValueError(
                    f"rotation target {tgt!r} is an output; outputs only "
                    "provide boundary values and cannot receive sweep results"
                )
            so, st = (tuple(getattr(fields[n], "shape", fields[n])) if n in fields else None
                      for n in (o, tgt))
            if so is not None and so != st:
                raise ValueError(
                    f"rotation {o!r} -> {tgt!r} joins fields of different "
                    f"shapes {so} vs {st}; double-buffer partners must share one "
                    "staggering"
                )

    def cache_size(self) -> int:
        """Field sets traced plus CUDA libraries loaded for this kernel: it
        grows when a call traces or builds, so a caller can tell a cold call
        from a warm one."""
        return len(self._ir_cache) + sum(c._lib is not None for c in self._calls.values())

    @property
    def launch_info(self) -> dict:
        """Launch parameters of the generated kernels, by grid shape: the
        grid, block and chunk, the axis the launch marched (None for the
        all-parallel layout), the planes its march keeps live
        (``queue_planes``, 0 when it does not march) and whether a marched
        kernel fell back to the all-parallel launch (``march_fallback``), and
        the kernel's layout (``codegen.layout_name``: tile, planes per step,
        resident blocks, ``/slab-async`` for the march along the contiguous
        axis)."""
        return {
            shape: {"grid": v.grid, "block": v.block, "xc": v.xc,
                    "march_axis": call.march_axis, "queue_planes": call.queue_planes,
                    "march_fallback": call.march_fallback,
                    "layout": v.layout or codegen.layout_name(call.shape)}
            for call in self._calls.values()
            for shape, v in call.launch_info.items()
        }
