"""Communication/computation overlap (the paper's ``@hide_communication``).

ParallelStencil + ImplicitGlobalGrid hide the halo exchange behind the
stencil update of the interior: the boundary-adjacent cells are computed in
separate kernels once the halos arrive, while the bulk of the domain is
updated concurrently with communication. That is what gave the paper >95%
parallel efficiency on 1024 GPUs.

The reference is dataflow-structured (XLA schedules the bulk update between
the start and the end of an async ``ppermute``). The port is
stream-structured, as the paper's CUDA original is. ``overlapped_step``:

  1. launches the bulk update with the stale ghosts on the compute stream;
  2. packs the interior slabs on a side stream and sends and receives them
     (``halo.begin_many``; the host waits in the transport while the bulk
     runs on the card);
  3. writes the received ghosts into the fields on the compute stream,
     behind an event of the side stream, so after the bulk launch has read
     them (the bulk reads the very ghost cells this writes);
  4. re-updates the shell per face from a slab of the fresh fields and
     pastes it into the bulk's outputs.

The shell slab of a face is ghost r + shell r + max(support, ring) thick
and spans the full extent of the other axes, so edge and corner cells are
recomputed consistently by every adjacent face (last write wins with
identical values). A face with no neighbour (a non-periodic edge) received
no ghosts, every cell the bulk read there is current, and it is not
re-updated (the reference re-updates every face). A slab along a non-leading axis is a strided view: it
is copied contiguous for the generated kernel. On the CPU the same steps
run one after another, with the same values.

Reductions (deliberately unlike the reference, whose ``finish_reductions``
combines the fused values of whole local blocks): ``sequential_step`` and
``overlapped_step`` fold a kernel's reductions over the cells each rank
*owns* (``halo.owned_slices``: its interior, and the physical boundary
layers on the global edges), then combine them with one ``all_reduce``
each. Over the ranks those cells tile the global array once, so a max
equals the single-process value bitwise, and a sum counts every cell once
(equal up to reassociation). A whole local block would add its ghost ring:
duplicates of the neighbours' cells in the inputs, but the output's ghost
ring holds the buffer's older values, so a ``max_abs_diff`` there is a
stale difference, and a sum counts the ring twice. ``multi_step`` keeps the
reference's fused reductions of the k-step launch, whole block included
(after k sweeps the ghost ring is stale anyway).
"""
from __future__ import annotations

import time
from typing import Callable, Mapping, Sequence

import torch

from .. import telemetry as _telemetry
from . import fault as _fault
from . import halo as _halo

__all__ = ["finish_reductions", "owned_reductions", "MonitoredStepper", "monitored",
           "sequential_step", "multi_step", "overlapped_step", "shell_slabs"]


def _face_slab(arr, axis: int, side: int, thickness: int, off: int = 0):
    """Face slab covering base positions [0, thickness) / [N-thickness, N).
    A field staggered by ``off`` along ``axis`` (extent ``N - off``) yields
    a ``thickness - off`` slab over the same physical region, so slab sets
    keep the coupled system's staggering intact for the kernel's shape
    contract."""
    t = thickness - off
    return arr.narrow(axis, 0 if side == 0 else arr.shape[axis] - t, t)


def _paste_shell(dst, src, axis: int, side: int, radius: int) -> None:
    """Paste the ghost + shell layers ([0, 2r) from the face) of ``src``
    into ``dst`` in place. Including the ghost ring keeps overlapped_step
    bit-equal to the sequential step for ``@all``-write outputs too (whose
    ghost cells are computed from exchanged values, not just carried)."""
    r = radius
    dst.narrow(axis, 0 if side == 0 else dst.shape[axis] - 2 * r, 2 * r).copy_(
        src.narrow(axis, 0 if side == 0 else src.shape[axis] - 2 * r, 2 * r))


def _kernel_geometry(kernel, fields, scalars, exchange: Sequence[str], mesh):
    """(radius, per-exchanged-field exchange depths, ir) for this field set:
    the inferred radius, and each field's per-axis/per-side read depth on
    the decomposed (leading) axes."""
    ir = kernel.stencil_ir(**fields, **scalars)
    r = max(ir.inferred_radius, 1)
    n_dec = len(mesh.shape)
    depths = {f: ir.field_halo[f][:n_dec] for f in exchange if f in ir.field_halo}
    return r, depths, ir


def finish_reductions(kernel, reds: Mapping[str, torch.Tensor], mesh) -> dict:
    """Finish a kernel's reductions across ranks: ONE ``all_reduce``
    (``MAX``/``SUM``) per reduction of the rank-local values, on the mesh's
    process group (the combines are associative)."""
    return {n: kernel.reductions[n].all_reduce(v, mesh.group) for n, v in reds.items()}


def owned_reductions(kernel, outs: Mapping[str, torch.Tensor],
                     fields: Mapping[str, torch.Tensor], mesh, radius: int) -> dict:
    """The kernel's reductions folded over the cells this rank owns
    (``halo.owned_slices``) and combined across ranks (module docstring)."""
    factors, index = mesh.shape, mesh.coords

    def own(t):
        return t[_halo.owned_slices(t.shape, factors, index, radius)]

    reds = kernel.apply_reductions({n: own(v) for n, v in outs.items()},
                                   {n: own(v) for n, v in fields.items()})
    return finish_reductions(kernel, reds, mesh)


class MonitoredStepper:
    """Rank-failure detection wired around the distributed step drivers.

    Wraps a host-level step callable: every call waits for the card (when
    the result holds CUDA tensors), records the wall time with the
    :class:`~repro_torch.distributed.fault.StepMonitor` (which bumps this
    rank's heartbeat file), and polls the peers' heartbeats. A stale peer
    raises :class:`~repro_torch.distributed.fault.RankFailure` so the
    launcher can restore from the checkpoint on the surviving ranks;
    stragglers show on ``.last_health`` without interrupting the run."""

    def __init__(self, step: Callable, monitor: "_fault.StepMonitor",
                 nsteps_per_call: int = 1, check_peers_every: int = 1):
        self.step = step
        self.monitor = monitor
        self.nsteps_per_call = max(int(nsteps_per_call), 1)
        self.check_peers_every = max(int(check_peers_every), 1)
        self.calls = 0
        self.last_health = {"dead": [], "stragglers": [], "healthy": 1}

    def __call__(self, *args, **kwargs):
        w0 = time.time()
        t0 = time.perf_counter()
        out = self.step(*args, **kwargs)
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        self.calls += 1
        self.monitor.record(self.calls * self.nsteps_per_call, dt / self.nsteps_per_call)
        col = _telemetry.get()
        if col.enabled:
            col.span_end("distributed.step", w0, dt,
                         {"call": self.calls, "steps": self.nsteps_per_call,
                          "per_step_s": dt / self.nsteps_per_call})
            col.count("distributed.steps", self.nsteps_per_call)
        if self.calls % self.check_peers_every == 0:
            self.last_health = self.monitor.check_peers()
            if self.last_health["dead"]:
                raise _fault.RankFailure(self.last_health["dead"])
        return out


def monitored(step: Callable, monitor: "_fault.StepMonitor", **kwargs) -> MonitoredStepper:
    """``monitored(step, StepMonitor(...))``: see :class:`MonitoredStepper`."""
    return MonitoredStepper(step, monitor, **kwargs)


def sequential_step(kernel, fields: Mapping[str, torch.Tensor], scalars: Mapping[str, object],
                    exchange: Sequence[str], mesh, periodic=False,
                    halo_compress: str | None = None,
                    timer: _halo.ExchangeTimer | None = None):
    """The reference order: exchange the ghosts (each field to its read
    depth), then update. Returns ``(result, fresh)``: the kernel's outputs
    (a tensor for one output, a dict otherwise) and the fields with
    refreshed ghosts (the same tensors, written in place). A kernel with
    reductions returns ``((outs, reds), fresh)``, the reductions folded
    over the owned cells and combined across ranks (module docstring).
    ``halo_compress`` selects the ghost wire format."""
    r, depths, _ = _kernel_geometry(kernel, fields, scalars, exchange, mesh)
    fresh = _halo.exchange_many(fields, exchange, mesh, radius=r, periodic=periodic,
                                depths=depths, compress=halo_compress, timer=timer)
    res = kernel.with_reductions(None)(**fresh, **scalars)
    if kernel.reductions:
        outs = {kernel.outputs[0]: res} if len(kernel.outputs) == 1 else res
        res = (res, owned_reductions(kernel, outs, fresh, mesh, r))
    return res, fresh


def multi_step(kernel, fields: Mapping[str, torch.Tensor], scalars: Mapping[str, object],
               exchange: Sequence[str], mesh, nsteps: int, periodic=False,
               halo_compress: str | None = None,
               timer: _halo.ExchangeTimer | None = None):
    """Temporal blocking across ranks: ONE deep halo exchange feeds k fused
    local steps (``kernel.run_steps(k)``, the generated k-step kernel on
    the card), k times fewer messages, each k*r wide.

    Local tensors must carry ``nsteps * r`` ghost layers. After the k
    sweeps the owned interior (depth >= k*r from the local edge) is exact;
    the ghost ring is stale and must be re-exchanged before the next block.
    Each field refreshes ``k * depth`` per axis and side. Returns (final
    outputs, fresh fields); a kernel with reductions returns its fused
    values of the last sweep, whole local block included, combined across
    ranks."""
    r, depths, _ = _kernel_geometry(kernel, fields, scalars, exchange, mesh)
    depths = {f: tuple((nsteps * lo, nsteps * hi) for lo, hi in d) for f, d in depths.items()}
    fresh = _halo.exchange_many(fields, exchange, mesh, radius=nsteps * r, periodic=periodic,
                                depths=depths, compress=halo_compress, timer=timer)
    res = kernel.run_steps(nsteps, **fresh, **scalars)
    if kernel.reductions:
        outs, reds = res
        res = (outs, finish_reductions(kernel, reds, mesh))
    return res, fresh


def shell_slabs(kernel, fields, scalars, exchange: Sequence[str], mesh) -> list:
    """``[(axis, side, {field: slab shape})]`` of the shell re-updates
    ``overlapped_step`` launches for this field set: what a caller builds
    before the ranks start (the slabs are shapes the bulk never has)."""
    shapes = {n: tuple(getattr(v, "shape", v)) for n, v in fields.items()}
    r, _, ir = _kernel_geometry(kernel, shapes, scalars, exchange, mesh)
    thick, base = _shell_geometry(ir, shapes, r)
    out = []
    for axis in range(min(len(mesh.shape), len(base))):
        for side in (0, 1):
            out.append((axis, side, {
                n: tuple(thick[axis][side] - (base[axis] - v[axis]) if a == axis else s
                         for a, s in enumerate(v))
                for n, v in shapes.items()}))
    return out


def _shell_geometry(ir, shapes, r: int):
    """The slab thickness per (axis, side) and the coupled set's base
    extents (``shapes``: the fields' shapes). The slab holds the shell's
    reads (support) and writes (ring): ghost r + shell r + max(support,
    ring) per face."""
    nd = len(next(iter(shapes.values())))
    base = tuple(max(v[a] for v in shapes.values()) for a in range(nd))
    w_max = tuple(max(rings[a] for rings in ir.write_rings.values()) for a in range(nd))
    thick = tuple((2 * r + max(ir.halo[a][1], w_max[a]),    # the low face reads "up"
                   2 * r + max(ir.halo[a][0], w_max[a]))    # the high face reads "down"
                  for a in range(nd))
    return thick, base


def overlapped_step(kernel, fields: Mapping[str, torch.Tensor], scalars: Mapping[str, object],
                    exchange: Sequence[str], mesh, periodic=False,
                    march_axis: int | None = None, halo_compress: str | None = None,
                    timer: _halo.ExchangeTimer | None = None):
    """@hide_communication: the bulk update overlaps the halo exchange
    (module docstring). Returns ``(updated_outputs, fresh_fields)`` like
    :func:`sequential_step`, and is bitwise equal to it: a tensor for one
    output, an out-name dict for coupled systems (the whole field group
    travels in one message per direction); with reductions
    ``((outs, reds), fresh)``, folded over the pasted outputs' owned cells.

    Each field exchanges its read depth, as in :func:`sequential_step` (the
    reference's overlapped step refreshes the whole ring; the ghost cells
    no stencil reads are all that differs, and with them the ghost ring of
    an output that is also an exchanged input).

    ``march_axis`` streams the bulk update (``kernel.marched``); the shell
    re-updates stay all-parallel: their slabs are a few cells thick,
    thinner than a plane queue. Outputs staggered along a decomposed axis
    are refused (exchange the cell fields and recompute fluxes locally)."""
    r, depths, ir = _kernel_geometry(kernel, fields, scalars, exchange, mesh)
    plain = kernel.with_reductions(None)
    single = len(kernel.outputs) == 1
    thick, base = _shell_geometry(ir, {n: tuple(v.shape) for n, v in fields.items()}, r)
    n_dec = min(len(mesh.shape), len(base))
    for axis in range(n_dec):
        for o in kernel.outputs:
            if fields[o].shape[axis] != base[axis]:
                raise NotImplementedError(
                    f"output {o!r} is staggered along decomposed axis {axis}; "
                    "overlapped_step supports staggered inputs only: keep face fields "
                    "rank-local (recompute them from exchanged cell fields)")

    def as_dict(res):
        return {kernel.outputs[0]: res} if single else dict(res)

    # 1) the bulk update with the stale ghosts, on the compute stream; the
    #    side stream packs behind an event recorded before it, not behind it
    ready = None
    dev = next(iter(fields.values())).device
    if dev.type == "cuda":
        ready = torch.cuda.Event()
        ready.record(torch.cuda.current_stream(dev))
    bulk_kernel = plain if march_axis is None else plain.marched(march_axis)
    bulk = as_dict(bulk_kernel(**fields, **scalars))
    # 2) the exchange: packed on the side stream, sent and received while the
    #    bulk runs; 3) the ghosts written behind the bulk launch
    fresh = _halo.begin_many(fields, exchange, mesh, radius=r, periodic=periodic,
                             depths=depths, compress=halo_compress, timer=timer,
                             ready=ready).finish()
    # 4) the shell re-updated per face from fresh slabs, and pasted; a face
    #    with no neighbour received nothing, so the bulk is already right there
    per = [periodic] * n_dec if isinstance(periodic, bool) else list(periodic)
    for axis in range(n_dec):
        for side in (0, 1):
            if mesh.neighbor(axis, 1 if side else -1, per[axis]) is None:
                continue
            slab_fields = {n: _face_slab(v, axis, side, thick[axis][side],
                                         off=base[axis] - v.shape[axis]).contiguous()
                           for n, v in fresh.items()}
            slab_out = as_dict(plain(**slab_fields, **scalars))
            for o in kernel.outputs:
                _paste_shell(bulk[o], slab_out[o], axis, side, r)
    res = bulk[kernel.outputs[0]] if single else bulk
    if kernel.reductions:
        res = (res, owned_reductions(kernel, bulk, fresh, mesh, r))
    return res, fresh
