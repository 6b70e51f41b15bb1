"""Convergence-driven iteration (``solve_until``).

The paper's solvers iterate until ``err = max|dT|`` drops under a
tolerance. The kernel's fused reduction gives the error as a device scalar
that costs no extra pass over the fields. The reference runs the whole
iteration as one device loop with no host transfers; this port runs a host
loop: each check block is ``check_every - 1`` launches of the plain kernel
and one launch of the checked kernel, then one read of the error scalar on
the host (a device synchronisation). :attr:`SolveResult.host_syncs` counts
those reads, so the gap from the reference's zero stays visible.

With bf16 or f16 storage the fields stay at their storage dtype across
checks, and the error is folded at the kernel's ``acc_dtype`` (f32).

``until="below"`` runs while ``err > tol`` (convergence); ``until="above"``
runs while ``err <= tol`` (drift guard). Steps are taken in multiples of
``check_every``: ``iters`` may overshoot ``max_iters`` by at most
``check_every - 1``.

Fault tolerance (``checkpoint=``): the paper's pseudo-transient solvers run
for days, and at that scale runs die to preemption, not math. The
checkpointing driver runs the same check loop in chunks of ``save_every``
checks and hands the double-buffer carry (the field buffers, the last
reductions and the error) to a :class:`~repro_torch.checkpoint.
CheckpointManager` between chunks. An async save stalls the loop only for
the device-to-host copy; the write runs behind the next chunk. Per-step
arithmetic never sees a chunk boundary, so a checkpointed solve equals the
plain one bitwise, and a run killed between chunks resumes from ``LATEST``
bitwise equal to the uninterrupted run.

Telemetry (``telemetry=`` / ``REPRO_TELEMETRY=1``): device-derived metrics
(steps, the error trajectory, reduction values) are read only at host syncs
the solve already makes: the chunk boundary of the checkpointing driver
and the final result of the plain loop. With telemetry off a solve makes
the same launches and host syncs as without it; the disabled path costs
one attribute check.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, Callable, Mapping, Optional, Union

import torch

from .. import telemetry as _telemetry
from ..telemetry import attrib as _attrib

__all__ = ["Checkpointing", "SolveResult", "make_solver", "solve_until"]


@dataclasses.dataclass
class Checkpointing:
    """Checkpoint policy for :func:`solve_until`.

    ``path`` is the checkpoint root directory (or an existing
    :class:`~repro_torch.checkpoint.CheckpointManager`). ``save_every``
    counts CHECKS between saves: the snapshot follows a check's host sync,
    so it never costs an extra pass over the fields; per step it costs the
    device-to-host copy over ``save_every * check_every`` steps.
    ``resume=True`` restores from ``LATEST`` when one exists (a fresh
    directory starts from the given initial fields). ``blocking=False``
    writes on a background thread. ``monitor`` (a
    :class:`~repro_torch.distributed.fault.StepMonitor`) bumps a heartbeat
    file per chunk and raises :class:`~repro_torch.distributed.fault.
    RankFailure` when a peer's heartbeat goes stale."""

    path: Union[str, Any]          # root dir or CheckpointManager
    save_every: int = 1            # checks between saves
    keep: int = 3
    resume: bool = True
    blocking: bool = False
    monitor: Optional[Any] = None  # fault.StepMonitor

    def manager(self):
        from ..checkpoint import CheckpointManager

        if isinstance(self.path, str):
            return CheckpointManager(self.path, keep=self.keep)
        return self.path


@dataclasses.dataclass
class SolveResult:
    """Final state of a convergence-driven solve."""

    fields: dict[str, torch.Tensor]   # all field buffers, rotated
    reds: dict[str, torch.Tensor]     # the last check's fused reductions
    err: float                        # last error value
    iters: int                        # steps taken
    host_syncs: int                   # device-to-host reads of the error
    resumed_from: Optional[int] = None     # checkpoint step a resume started at
    saved_steps: tuple[int, ...] = ()      # steps checkpointed this run
    # per-rank EWMA step stats from the run's StepMonitor (own rank plus
    # every peer heartbeat), {rank: {"ewma_s", "last_s", "n"}}; None when
    # the solve ran without a monitor
    step_stats: Optional[dict[int, dict[str, float]]] = None

    def output(self, kernel) -> Any:
        """The solver's answer: the rotation target of each output holds
        the newest value after the final rotation."""
        tgts = {o: self.fields[t] for o, t in kernel.rotations.items()}
        if len(kernel.outputs) == 1:
            return tgts[kernel.outputs[0]]
        return tgts


def _resolve_error(kernel, error) -> Callable[[Mapping[str, Any]], Any]:
    if error is None:
        if len(kernel.reductions) != 1:
            raise ValueError(
                f"kernel declares reductions {tuple(kernel.reductions)}; "
                "pass error=<name> (or a callable over the reduction dict) "
                "to pick the convergence scalar"
            )
        error = next(iter(kernel.reductions))
    if isinstance(error, str):
        if error not in kernel.reductions:
            raise ValueError(
                f"error={error!r} is not a declared reduction "
                f"(have {tuple(kernel.reductions)})"
            )
        name = error
        return lambda reds: reds[name]
    return error


def _f32(x: float) -> float:
    """``x`` rounded to f32: the error is an f32 value, so tol is compared
    at f32, as the reference's device loop does."""
    return float(torch.tensor(float(x), dtype=torch.float32))


def _keep_going(err: float, tol: float, until: str) -> bool:
    """The check loop's continue test (a NaN error stops it either way)."""
    return err > tol if until == "below" else err <= tol


def make_solver(kernel, scalars: Mapping[str, Any] | None = None, *,
                check_every: int = 1, error: str | Callable | None = None,
                until: str = "below", step: Callable | None = None):
    """Build ``solver(fields, tol, max_iters) -> SolveResult``.

    ``step(kern, fields) -> (result, fields)`` takes one step of ``kern``,
    the plain kernel or the checked one (whose result is ``(outs,
    reds)``), and returns the fields the rotation starts from. By default
    it is the kernel call itself; the distributed solver exchanges the
    ghost rings first (``distributed.elastic.make_elastic_solver``)."""
    if not kernel.reductions:
        raise ValueError(
            "solve_until needs a kernel with fused reductions "
            "(declare reductions={'err': 'max_abs_diff(T2, T)'}-style on @parallel)"
        )
    rot = kernel.rotations
    if not rot or set(kernel.outputs) - set(rot):
        raise ValueError(
            "solve_until rotates double buffers between steps and needs "
            "rotations covering every output (pass rotations={'T2': 'T'}-style "
            "mapping to @parallel)"
        )
    check_every = int(check_every)
    if check_every < 1:
        raise ValueError(f"check_every must be >= 1, got {check_every}")
    if until not in ("below", "above"):
        raise ValueError(f"until must be 'below' or 'above', got {until!r}")
    err_fn = _resolve_error(kernel, error)
    scalars = dict(scalars or {})
    plain = kernel.with_reductions(None)
    single = len(kernel.outputs) == 1
    if step is None:
        def step(kern, cur):
            return kern(**cur, **scalars), cur

    def rotate(cur, res):
        outs = {kernel.outputs[0]: res} if single else res
        cur = dict(cur)
        for o, tgt in rot.items():
            cur[o], cur[tgt] = cur[tgt], outs[o]
        return cur

    def solver(fields: Mapping[str, torch.Tensor], tol: float, max_iters: int) -> SolveResult:
        kernel.check_rotations(fields)
        tol = _f32(tol)
        # the fields are carried at the kernel's storage dtype (rounded once
        # here if given wider); the error is a reduction at its acc_dtype
        cur = {n: v.to(kernel.ps.dtype) for n, v in fields.items()}
        reds: dict[str, torch.Tensor] = {}
        err = math.inf if until == "below" else -math.inf
        it = syncs = 0
        while _keep_going(err, tol, until) and it < max_iters:
            for _ in range(check_every - 1):
                res, cur = step(plain, cur)
                cur = rotate(cur, res)
            (res, reds), cur = step(kernel, cur)
            cur = rotate(cur, res)
            it += check_every
            # the check's one host sync; the error is compared at f32, as the
            # reference's device loop holds it, whatever err_fn computes in
            err = _f32(err_fn(reds))
            syncs += 1
        return SolveResult(fields=cur, reds=reds, err=err, iters=it, host_syncs=syncs)

    return solver


def _cache_size(kernel) -> int:
    """What a solve's first call traces and builds (the checked kernel and
    its plain twin): a change across a call marks it cold."""
    return kernel.cache_size() + kernel.with_reductions(None).cache_size()


def _roofline(col, kernel, fields, scalars, per_step_s, check_every):
    """Roofline-gap attribution of an instrumented solve: the measured
    seconds per step against the least time of the step's traffic and
    flops (:func:`~repro_torch.telemetry.attrib.least_per_step_s`), with
    the check's partials at the launch's own tile on the card and the
    whole grid on the ``torch`` backend."""
    sc = dict(scalars or {})
    cost = kernel.cost_model(**fields, **sc)
    tile = march = None
    if kernel.ps.backend == "cuda":
        call = kernel.compiled(**fields, **sc)
        props = torch.cuda.get_device_properties(kernel.ps.device)
        tile, march = call.cost_tile(props.multi_processor_count), call.march_axis
    _attrib.attribute(col, kernel.label, per_step_s, cost, tile=tile,
                      march_axis=march, check_every=int(check_every), fused_checks=True,
                      hw=_attrib.default_hardware(kernel.ps.device.type))


def _resume(mgr, fields: Mapping[str, torch.Tensor], reds: Mapping[str, torch.Tensor],
           col=_telemetry.NULL) -> Optional[tuple]:
    """The carry of ``mgr``'s ``LATEST`` checkpoint, shaped like ``fields``
    and ``reds``: ``(fields, reds, err, iters)``, or None when there is
    none (a fresh directory)."""
    if mgr.latest_step() is None:
        return None
    # the error rides on the host: it is a Python float in the loop
    like = {"fields": fields, "reds": reds, "err": torch.zeros((), dtype=torch.float32)}
    tree, extra = mgr.restore(like)
    err, done = float(tree["err"]), int(extra.get("iters", extra["step"]))
    if col.enabled:
        ev = {"step": done, "err": err}
        if extra.get("skipped_corrupt"):
            # torn steps the fallback walked past (step, reason)
            ev["skipped_corrupt"] = [s for s, _ in extra["skipped_corrupt"]]
        col.event("solve.resume", **ev)
    return tree["fields"], tree["reds"], err, done


def _run_chunks(solver, cur: dict, reds: dict, *, tol: float, max_iters: int,
               check_every: int, until: str, ckpt: Optional[Checkpointing] = None,
               mgr=None, start: Optional[tuple] = None, col=_telemetry.NULL,
               gather: Optional[Callable] = None, extra: Optional[dict] = None,
               after_save: Optional[Callable] = None,
               on_chunk: Optional[Callable] = None) -> tuple[SolveResult, list]:
    """The chunked check loop behind ``solve_until(checkpoint=...)`` and
    the distributed ``elastic_solve_until``.

    Each chunk is ``solver`` (:func:`make_solver`) capped at ``save_every``
    checks (the whole run without ``ckpt``), so per-step arithmetic never
    sees a chunk boundary. ``start`` is ``(err, iters)`` of a resumed
    carry. Between chunks the heartbeat monitor and the checkpoint save
    run, then ``on_chunk(iters)``, then the FaultPlan's step hook: a
    planned kill or hang lands after the save it follows has completed.
    ``gather(cur)`` gives the fields a save writes (None: this process
    writes nothing), ``extra`` what its manifest adds, ``after_save()``
    runs on every process after it. Returns the result (its ``fields``
    the carry) and ``(seconds, steps)`` per chunk. ``host_syncs`` counts
    the error reads; the snapshots' copies come on top."""
    from ..distributed import fault

    save_every = int(ckpt.save_every) if ckpt is not None else 1
    if save_every < 1:
        raise ValueError(f"save_every must be >= 1, got {save_every}")
    block = save_every * int(check_every) if ckpt is not None else max_iters + check_every
    tol32 = _f32(tol)
    err = math.inf if until == "below" else -math.inf
    done, resumed_from = 0, None
    if start is not None:
        err, done = start
        resumed_from = done
    plan = fault.FaultPlan.active()
    monitor = ckpt.monitor if ckpt is not None else None
    syncs, saved = 0, []
    chunks: list[tuple[float, int]] = []   # (seconds, steps) per chunk
    converged = done > 0 and not _keep_going(err, tol32, until)
    while not converged and done < max_iters:
        take = min(block, max_iters - done)
        w0, t0 = time.time(), time.perf_counter()
        res = solver(cur, tol, take)      # ends with the last check's host sync
        dt = time.perf_counter() - t0
        cur, reds, err, n = res.fields, res.reds, res.err, res.iters
        syncs += res.host_syncs
        done += n
        converged = not _keep_going(err, tol32, until)
        chunks.append((dt, n))
        if col.enabled:
            # read only what this boundary has synced: iters, err, and the
            # reductions of the check that just finished
            per = dt / max(n, 1)
            col.span_end("solve.chunk", w0, dt,
                         {"steps": n, "iters": done, "err": err, "per_step_s": per,
                          "cold": len(chunks) == 1})
            col.count("solve.steps", n)
            col.event("solve.trajectory", iters=done, err=err, per_step_s=per,
                      reds={k: float(v) for k, v in reds.items()})
        if monitor is not None:
            monitor.record(done, dt / max(n, 1))
            health = monitor.check_peers()
            if health["dead"]:
                if mgr is not None:
                    mgr.wait()
                raise fault.RankFailure(health["dead"])
        fires = plan is not None and plan.fires_at(done)
        if mgr is not None:
            # async: stalls only for the device-to-host snapshot; the write
            # overlaps the next chunk's device work
            fields = cur if gather is None else gather(cur)
            if fields is not None:
                mgr.save(done, {"fields": fields, "reds": reds,
                                "err": torch.tensor(err, dtype=torch.float32)},
                         blocking=ckpt.blocking,
                         extra={"iters": done, "err": err, "tol": tol32,
                                "check_every": int(check_every), "save_every": save_every,
                                "until": until, **(extra or {}), "converged": converged})
                if fires:
                    mgr.wait()
            saved.append(done)
            if after_save is not None:
                after_save()
        if on_chunk is not None:
            on_chunk(done)
        if fires:
            # LATEST now names the step the kill or hang lands after
            plan.on_step(done)
    if mgr is not None:
        mgr.wait()                       # surface async write failures
    stats = monitor.snapshot() if monitor is not None else None
    return SolveResult(fields=cur, reds=reds, err=err, iters=done, host_syncs=syncs,
                       resumed_from=resumed_from, saved_steps=tuple(saved),
                       step_stats=stats), chunks


def _solve_checkpointed(kernel, fields, scalars, *, tol, max_iters, check_every, error,
                        until, ckpt: Checkpointing, col=_telemetry.NULL) -> SolveResult:
    """``solve_until(checkpoint=...)``: :func:`_run_chunks` over the plain
    solver, resumed from ``LATEST`` when ``ckpt.resume``."""
    mgr = ckpt.manager()
    solver = make_solver(kernel, scalars, check_every=check_every, error=error, until=until)
    # storage-dtype carry (as in the plain solver): checkpoints hold the
    # storage dtype too, so a resume continues from exactly these bits
    cur = {n: v.to(kernel.ps.dtype) for n, v in fields.items()}
    dev = next(iter(cur.values())).device
    reds = {n: torch.zeros((), dtype=kernel.ps.acc_dtype, device=dev) for n in kernel.reductions}
    got = _resume(mgr, cur, reds, col) if ckpt.resume else None
    if got is not None:
        cur, reds = got[0], got[1]
    res, chunks = _run_chunks(solver, cur, reds, tol=tol, max_iters=max_iters,
                             check_every=check_every, until=until, ckpt=ckpt, mgr=mgr,
                             start=got[2:] if got is not None else None, col=col)
    if col.enabled:
        col.gauge("solve.iters", res.iters)
        col.gauge("solve.err", res.err)
        # seconds per step for the roofline gap: warm chunks only (the first
        # may trace and build) unless the run was one chunk
        warm = chunks[1:] if len(chunks) > 1 else chunks
        steps = sum(n for _, n in warm)
        if steps:
            _roofline(col, kernel, res.fields, scalars, sum(dt for dt, _ in warm) / steps,
                      check_every)
    return res


def solve_until(kernel, fields: Mapping[str, torch.Tensor],
                scalars: Mapping[str, Any] | None = None, *, tol: float,
                max_iters: int, check_every: int = 1,
                error: str | Callable | None = None, until: str = "below",
                checkpoint: Union[Checkpointing, str, None] = None,
                telemetry: Any = None) -> SolveResult:
    """Iterate ``kernel`` until its fused error scalar crosses ``tol`` (or
    ``max_iters`` steps), checking every ``check_every`` steps.

    ``kernel`` is a :class:`~repro_torch.core.parallel.StencilKernel` with
    ``reductions=`` and ``rotations=`` declared; ``fields`` maps every field
    argument to its initial tensor, ``scalars`` the non-field arguments.
    ``error`` picks the convergence scalar: a reduction name (default: the
    single declared reduction) or a callable over the reduction dict.

    ``checkpoint`` (a directory path or :class:`Checkpointing`) makes the
    solve survivable: the loop runs in chunks of ``save_every`` checks, the
    carry is checkpointed after each, and an interrupted run restarted with
    the same arguments resumes from the last atomic checkpoint.

    ``telemetry`` selects a collector: ``None`` inherits the process
    singleton (env ``REPRO_TELEMETRY``), ``False`` forces it off,
    ``True``/a ``Collector`` forces it on. Device values are read only at
    the host syncs the solve makes anyway.
    """
    col = _telemetry.resolve(telemetry)
    if checkpoint is not None:
        if isinstance(checkpoint, str):
            checkpoint = Checkpointing(checkpoint)
        return _solve_checkpointed(kernel, dict(fields), scalars, tol=tol,
                                   max_iters=max_iters, check_every=check_every,
                                   error=error, until=until, ckpt=checkpoint, col=col)
    solver = make_solver(kernel, scalars, check_every=check_every, error=error, until=until)
    if not col.enabled:
        return solver(fields, tol, max_iters)
    # instrumented plain path: the same loop, timed on the host clock (its
    # last error read waits for the device); a call that traced or built a
    # kernel is cold and stays out of the roofline attribution
    before = _cache_size(kernel)
    w0, t0 = time.time(), time.perf_counter()
    res = solver(fields, tol, max_iters)
    dt = time.perf_counter() - t0
    cold = _cache_size(kernel) > before
    col.span_end("solve_until", w0, dt,
                 {"kernel": kernel.label, "iters": res.iters, "err": res.err,
                  "check_every": int(check_every), "cold": cold})
    col.count("solve.steps", res.iters)
    col.gauge("solve.iters", res.iters)
    col.gauge("solve.err", res.err)
    if res.iters and not cold:
        _roofline(col, kernel, res.fields, scalars, dt / res.iters, check_every)
    return res
