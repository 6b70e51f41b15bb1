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
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Mapping, Sequence

import torch

from .. import ir as _ir
from ..ir.reductions import UNPORTED_KINDS
from ..kernels import stencil as _stencil
from .device import on_device, resolve_device

_BACKENDS = ("cuda", "torch")


@dataclasses.dataclass(frozen=True)
class ParallelStencil:
    """Backend/dtype/ndims/device context (the paper's
    ``@init_parallel_stencil``)."""

    backend: str = "cuda"
    dtype: torch.dtype = torch.float32
    ndims: int = 3
    device: Any = "cuda"

    def __post_init__(self):
        if self.backend not in _BACKENDS:
            raise ValueError(f"backend must be one of {_BACKENDS}")
        if self.dtype != torch.float32:
            raise NotImplementedError(
                f"storage dtype {self.dtype} is not ported yet (ROADMAP queue 1, "
                "item 3: sub-f32 storage); fields are float32"
            )
        dev = resolve_device(self.device)
        if self.backend == "cuda" and dev.type != "cuda":
            raise ValueError(
                "backend='cuda' runs generated kernels on the card; use "
                "backend='torch' for device='cpu'"
            )
        object.__setattr__(self, "device", dev)

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
        ``(outputs, {name: 0-d tensor})``."""
        if bc is not None:
            raise NotImplementedError(
                "bc= is not ported yet (ROADMAP queue 1, item 3: bc "
                "dirichlet/neumann0, then periodic)"
            )
        if march_axis is not None:
            raise NotImplementedError(
                "march_axis= is not ported yet (ROADMAP queue 1, item 3: march_axis)"
            )

        def deco(fn: Callable) -> StencilKernel:
            return StencilKernel(self, fn, tuple(outputs), rotations, reductions)

        return deco


def init_parallel_stencil(backend: str = "cuda", dtype: torch.dtype = torch.float32,
                          ndims: int = 3, device="cuda") -> ParallelStencil:
    return ParallelStencil(backend=backend, dtype=dtype, ndims=ndims, device=device)


class StencilKernel:
    """A stencil kernel, traced and (on ``backend="cuda"``) compiled on first
    use for each set of field shapes."""

    def __init__(self, ps: ParallelStencil, fn: Callable, outputs: tuple[str, ...],
                 rotations: Mapping[str, str] | None = None,
                 reductions: Mapping[str, Any] | None = None):
        self.ps = ps
        self.fn = fn
        self.outputs = outputs
        self.rotations = dict(rotations) if rotations else None
        self.reductions = _ir.normalize_reductions(reductions)
        for name, r in self.reductions.items():
            if r.kind in UNPORTED_KINDS:
                raise NotImplementedError(
                    f"reduction {name!r} = {r.describe()}: the {r.kind!r} kind is "
                    "not ported yet (ROADMAP queue 1, item 3: finite/nan_count)"
                )
        self._ir_cache: dict = {}
        self._calls: dict = {}
        self._red_variants: dict = {}
        functools.update_wrapper(self, fn)

    @property
    def label(self) -> str:
        name = getattr(self.fn, "__name__", "kernel")
        return f"{name}[{','.join(self.reductions)}]" if self.reductions else name

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
            v = StencilKernel(self.ps, self.fn, self.outputs, self.rotations, reds)
            self._red_variants[key] = v
        return v

    def apply_reductions(self, outs: Mapping[str, torch.Tensor],
                         fields: Mapping[str, torch.Tensor]) -> dict[str, torch.Tensor]:
        """Whole-tensor folds of this kernel's reductions over the new
        outputs and the pre-step fields: what a separate pass computes."""
        reds = {}
        for name, r in self.reductions.items():
            ops = [outs[op] if op in outs else fields[op] for op in r.operands]
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
            _stencil.unsupported(ir)
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

    # -- backends -----------------------------------------------------------
    def _run_torch(self, fields, scalars, ir: _ir.StencilIR):
        updates = self.fn(**fields, **scalars)
        outs = {}
        for name in self.outputs:
            idx = tuple(slice(w, n - w) for w, n in
                        zip(ir.write_rings[name], fields[name].shape))
            out = fields[name].clone()
            out[idx] = updates[name]
            outs[name] = out
        reds = self.apply_reductions(outs, fields) if self.reductions else None
        return outs, reds

    def _call(self, ir: _ir.StencilIR) -> _stencil.StencilCall:
        call = self._calls.get(id(ir))
        if call is None:
            call = self._calls[id(ir)] = _stencil.StencilCall(ir, self.label)
        return call

    def compiled(self, **kwargs) -> _stencil.StencilCall:
        """The generated kernel for a field set (arguments as for
        :meth:`stencil_ir`); its ``source`` is what the build compiles."""
        return self._call(self.stencil_ir(**kwargs))

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
        """Advance ``nsteps`` fused time steps. Only ``nsteps=1`` is ported."""
        if int(nsteps) != 1:
            raise NotImplementedError(
                "run_steps(k > 1) is not ported yet (ROADMAP queue 1, item 3: "
                "run_steps(k) for both kernels)"
            )
        return self(**kwargs)

    @property
    def launch_info(self) -> dict:
        """Launch parameters of the generated kernels, by grid shape."""
        return {
            shape: {"grid": v.grid, "block": v.block, "xc": v.xc}
            for call in self._calls.values()
            for shape, v in call.launch_info.items()
        }
