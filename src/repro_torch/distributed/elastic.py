"""Elastic scaling: the distributed, survivable ``solve_until``.

A checkpoint written by one gang of ranks must restore onto another (a
failed node shrinks the gang; scale-up grows it). Checkpoints hold
*global* tensors (``checkpoint/manager.py``, the reference's on-disk
format), so restoring on any decomposition is: read the global arrays,
and let every rank cut its own block from them.

  * :func:`decompose_fields` / :func:`gather_fields`: global <-> per-rank
    ghost-ring layout (the ImplicitGlobalGrid decomposition, stacked with
    leading mesh-factor axes);
  * :func:`fetch_global`: the interiors of every rank, stitched into the
    global tensors, on every rank or on one (a gather over the rank
    mesh's group);
  * :func:`elastic_solve_until`: the distributed, checkpointing twin of
    :func:`repro_torch.core.iterate.solve_until`. Every rank runs the same
    host loop over its own block: ``check_every - 1`` plain steps and one
    checked step per check, each step ``overlap.sequential_step`` (or
    ``overlapped_step``): grouped halo exchange, the kernel, and one
    ``all_reduce`` per reduction, so the loop's test is rank-uniform.
    Chunked at check boundaries for checkpointing the *global* carry, a
    run killed on an N-rank gang resumes on an M-rank gang;
  * :func:`plan_factors` / :func:`plan_compatible` /
    :func:`validate_stencil_factors`: the shrink/regrow policy, a
    decomposition for the surviving world size whose interiors divide;
  * :func:`supervise`: the restart policy a launcher loops over.

The reference also re-shards pytrees of model parameters (``remesh``,
``from_host_callback``, ``validate_divisibility``); those belong to the
LM's sharded training and are not ported here.

Comparison contract: each cell's arithmetic is the single-process step's,
and the check's reductions fold each rank's owned cells
(``overlap.owned_reductions``), so the gathered fields and a max-kind
error equal the single-process ``solve_until``'s bitwise on the same
inputs, iterations included; sum-kind reductions reassociate.
"""
from __future__ import annotations

import math
from typing import Callable, Mapping, Optional, Sequence

import torch

from ..core.iterate import Checkpointing, SolveResult, _resume, _run_chunks, make_solver
from . import halo as _halo, overlap

__all__ = ["DEFAULT_AXES", "plan_factors", "plan_compatible", "validate_stencil_factors",
           "decompose_fields", "gather_fields", "fetch_global", "make_elastic_solver",
           "elastic_solve_until", "supervise"]

DEFAULT_AXES = ("x", "y", "z")
STEPS = ("sequential", "overlapped")


def plan_factors(n_ranks: int, ndims: int = 1) -> tuple[int, ...]:
    """A near-balanced decomposition of ``n_ranks`` over the leading
    ``ndims`` grid axes (largest factors first: row-major rank order).
    This is the shrink/regrow policy: after losing a rank, call it with
    the surviving world size."""
    if n_ranks < 1:
        raise ValueError(f"n_ranks must be >= 1, got {n_ranks}")
    factors = [1] * ndims
    rem = n_ranks
    for i in range(ndims - 1):
        f = 1
        for cand in range(int(math.isqrt(rem)), 0, -1):
            if rem % cand == 0:
                f = cand
                break
        factors[i] = max(rem // f, f) if ndims - i == 2 else f
        rem //= factors[i]
    factors[-1] = rem
    return tuple(sorted(factors, reverse=True))


def plan_compatible(shape: Sequence[int], radius: int, world: int,
                    ndims: int = 1) -> tuple[int, tuple[int, ...]]:
    """The supervisor's replan policy: the largest world size ``<= world``
    whose :func:`plan_factors` decomposition passes
    :func:`validate_stencil_factors` on this grid. After losing a rank, a
    4-rank world on an interior-16 grid must step down to 2, not 3 (3
    does not divide). Returns ``(world, factors)``; raises a pointed error
    when not even a single rank fits (grid thinner than the ghost ring)."""
    for w in range(int(world), 0, -1):
        factors = plan_factors(w, ndims)
        try:
            validate_stencil_factors(shape, factors, radius)
        except ValueError:
            continue
        return w, factors
    raise ValueError(
        f"no world size in [1, {world}] decomposes grid {tuple(shape)} (radius {radius}) "
        f"over {ndims} axis/axes: the grid interior is thinner than one ghost ring")


def validate_stencil_factors(shape: Sequence[int], factors: Sequence[int],
                             radius: int) -> None:
    """The ghost-ring decomposition contract: every decomposed axis'
    interior (extent minus the 2r physical boundary ring) must divide by
    its factor, and each rank block must be at least one ghost ring wide.
    Raises a pointed ValueError naming the failing axis."""
    for ax, f in enumerate(factors):
        inner = shape[ax] - 2 * radius
        if inner <= 0 or inner % f:
            raise ValueError(
                f"axis {ax}: interior extent {inner} (= {shape[ax]} - 2*r, r={radius}) "
                f"does not divide over {f} ranks: choose a mesh from divisors of {inner} "
                "(plan_factors of a compatible world size)")
        if inner // f < radius:
            raise ValueError(f"axis {ax}: rank block {inner // f} thinner than the ghost "
                             f"ring (r={radius}): fewer ranks needed")


def decompose_fields(fields: Mapping[str, torch.Tensor], factors: Sequence[int],
                     radius: int) -> dict:
    """Split global tensors into the stacked rank-local ghost layout: each
    field becomes shape ``(*factors, *local_shape)``."""
    out = {}
    for name, g in fields.items():
        locals_ = _halo.global_to_local(g, factors, radius=radius)
        out[name] = torch.stack(locals_).reshape(tuple(factors) + tuple(locals_[0].shape))
    return out


def gather_fields(stacked: Mapping[str, torch.Tensor], factors: Sequence[int],
                  radius: int) -> dict:
    """Inverse of :func:`decompose_fields` (interior stitching). This is
    what checkpoints store: the mesh-agnostic global tensors."""
    nrank = math.prod(factors)
    return {name: _halo.local_to_global(list(st.reshape((nrank,) + tuple(st.shape[len(factors):]))),
                                        factors, radius=radius)
            for name, st in stacked.items()}


def fetch_global(local: Mapping[str, torch.Tensor], mesh, radius: int,
                 to: Optional[int] = None) -> Optional[dict]:
    """The global tensors stitched from every rank's block (interiors and
    the physical boundary layers), through the mesh's group: on every rank
    (``to=None``, an all-gather) or on the rank at mesh position ``to``
    (a gather; the others get None). Every rank of the mesh must call it.
    On a gloo group CUDA blocks cross through the host, and the result
    lies on the CPU; otherwise on the blocks' device."""
    import torch.distributed as dist

    if mesh.size == 1 or not dist.is_initialized():
        return {k: _halo.local_to_global([v], mesh.shape, radius) for k, v in local.items()}
    out: dict = {}
    mine = to is None or mesh.position == to
    for k, v in local.items():
        t = v.cpu() if v.is_cuda and mesh.backend == "gloo" else v.contiguous()
        parts = [torch.empty_like(t) for _ in range(mesh.size)] if mine else None
        if to is None:
            dist.all_gather(parts, t, group=mesh.group)
        else:
            dist.gather(t, parts, dst=mesh.ranks[to], group=mesh.group)
        if mine:
            out[k] = _halo.local_to_global(parts, mesh.shape, radius)
    return out if mine else None


def make_elastic_solver(kernel, scalars: Mapping[str, object], mesh,
                        exchange: Sequence[str], *, check_every: int = 1, error=None,
                        until: str = "below", periodic: bool = False,
                        step: str = "sequential", march_axis: int | None = None,
                        halo_compress: str | None = None,
                        timer: _halo.ExchangeTimer | None = None):
    """The rank-local ``solver(local_fields, tol, max_iters) ->
    SolveResult``: :func:`repro_torch.core.iterate.make_solver` whose every
    step is ``overlap.sequential_step`` (``step="sequential"``) or
    ``overlap.overlapped_step`` (``step="overlapped"``, which also takes
    ``march_axis``), the check's reductions combined across ranks."""
    if step not in STEPS:
        raise ValueError(f"step must be one of {STEPS}, got {step!r}")
    kw = dict(periodic=periodic, halo_compress=halo_compress, timer=timer)
    if step == "overlapped":
        kw["march_axis"] = march_axis
        step_fn = overlap.overlapped_step
    else:
        if march_axis is not None:
            raise ValueError("march_axis streams the overlapped step's bulk update; "
                             "pass step='overlapped'")
        step_fn = overlap.sequential_step
    scalars = dict(scalars or {})

    def rank_step(kern, cur):
        return step_fn(kern, cur, scalars, exchange, mesh, **kw)

    return make_solver(kernel, scalars, check_every=check_every, error=error, until=until,
                       step=rank_step)


def elastic_solve_until(
    kernel,
    fields: Mapping[str, torch.Tensor],
    scalars: Mapping[str, object] | None = None,
    *,
    factors: Sequence[int],
    tol: float,
    max_iters: int,
    exchange: Sequence[str],
    check_every: int = 1,
    error=None,
    until: str = "below",
    periodic: bool = False,
    checkpoint=None,
    mesh_axes: Sequence[str] | None = None,
    radius: int | None = None,
    group=None,
    step: str = "sequential",
    march_axis: int | None = None,
    halo_compress: str | None = None,
    gather_to: Optional[int] = None,
    timer: _halo.ExchangeTimer | None = None,
    on_chunk: Optional[Callable[[int], None]] = None,
) -> SolveResult:
    """Distributed, survivable ``solve_until``: iterate ``kernel`` over a
    ``factors``-decomposed gang (the ranks of ``group``, None: the default
    group) until the rank-combined error crosses ``tol``. Every rank of the
    gang calls it with the same arguments.

    ``fields`` are GLOBAL tensors (physical boundary ring included) that
    every rank is given; each cuts its own block from them and moves it to
    the kernel's device. ``exchange`` names the fields whose ghost rings
    each step refreshes. ``checkpoint`` (a path or
    :class:`~repro_torch.core.iterate.Checkpointing`) chunks the loop at
    check boundaries and has rank 0 checkpoint the gathered *global*
    carry, so a killed run resumes on any compatible gang: ``factors`` at
    resume time may differ from those the checkpoint was written on.

    Returns a :class:`SolveResult` whose ``fields`` are the global tensors
    (on every rank, or only on the rank at mesh position ``gather_to``;
    the others get ``{}``). ``host_syncs`` counts the error reads.
    ``step``/``march_axis``/``halo_compress`` select the step driver
    (:func:`make_elastic_solver`); ``timer`` collects the exchanges'
    parts; ``on_chunk(iters)`` runs on every rank after each chunk (and
    its save), before a planned kill lands."""
    from ..launch.mesh import make_mesh

    scalars = dict(scalars or {})
    factors = tuple(int(f) for f in factors)
    axes = tuple(mesh_axes or DEFAULT_AXES[:len(factors)])
    mesh = make_mesh(factors, axes, group)
    dev = kernel.ps.device
    globals_ = {k: v.to(kernel.ps.dtype) for k, v in fields.items()}
    if radius is None:
        shapes = {k: tuple(v.shape) for k, v in globals_.items()}
        radius, _, _ = overlap._kernel_geometry(kernel, shapes, scalars, exchange, mesh)
    sample = next(iter(globals_.values()))
    validate_stencil_factors(sample.shape, factors, radius)

    ckpt = Checkpointing(checkpoint) if isinstance(checkpoint, str) else checkpoint
    mgr = ckpt.manager() if ckpt is not None else None
    reds = {n: torch.zeros((), dtype=kernel.ps.acc_dtype, device=dev) for n in kernel.reductions}
    got = _resume(mgr, globals_, reds) if ckpt is not None and ckpt.resume else None
    if got is not None:
        globals_, reds = got[0], got[1]
    # this rank's block of THIS gang's decomposition (maybe not the
    # checkpoint's), cut from the global tensors
    cur = {k: _halo.local_block(v, factors, mesh.coords, radius).to(dev)
           for k, v in globals_.items()}
    del globals_
    solver = make_elastic_solver(kernel, scalars, mesh, exchange, check_every=check_every,
                                 error=error, until=until, periodic=periodic, step=step,
                                 march_axis=march_axis, halo_compress=halo_compress,
                                 timer=timer)
    # the gather is a collective: every rank runs it, rank 0 writes (one
    # writer per shared checkpoint directory); the barrier holds every
    # rank, and so a planned kill, until rank 0's save has returned (a
    # blocking save has then landed)
    res, _ = _run_chunks(
        solver, cur, reds, tol=tol, max_iters=max_iters, check_every=check_every,
        until=until, ckpt=ckpt, mgr=mgr, start=got[2:] if got is not None else None,
        gather=lambda local: fetch_global(local, mesh, radius, to=0),
        extra={"factors": list(factors), "radius": int(radius)},
        after_save=lambda: _barrier(mesh), on_chunk=on_chunk)
    res.fields = fetch_global(res.fields, mesh, radius, to=gather_to) or {}
    return res


def _barrier(mesh) -> None:
    import torch.distributed as dist

    if dist.is_initialized() and mesh.size > 1:
        dist.barrier(group=mesh.group)


def supervise(run_attempt: Callable[[int, int], int], world: int, *,
              replan: Callable[[int, int], int] | None = None,
              max_restarts: int = 3) -> tuple[int, int, list[int]]:
    """Launcher restart loop: call ``run_attempt(attempt, world)`` until it
    returns 0.

    On a nonzero exit (a planned :data:`~repro_torch.distributed.fault.
    KILL_EXIT_CODE` death or a real crash) the world is re-planned,
    ``replan(world, rc)`` (default: lose one rank, floor 1), and the next
    attempt launches; the attempt's own checkpoint/resume logic carries
    the state across. Returns ``(attempts_used, final_world, exit_codes)``;
    raises after ``max_restarts`` failed restarts."""
    codes: list[int] = []
    attempt = 0
    while True:
        rc = int(run_attempt(attempt, world))
        codes.append(rc)
        if rc == 0:
            return attempt, world, codes
        if attempt >= max_restarts:
            raise RuntimeError(f"gave up after {attempt} restarts (exit codes {codes})")
        world = replan(world, rc) if replan is not None else max(world - 1, 1)
        attempt += 1
