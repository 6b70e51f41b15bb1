"""The batch engine: fixed-width device batches with continuous refill.

One :class:`BatchState` owns ``max_batch`` SLOTS over a single grid
bucket. The carry is the batched solver's (see
:func:`repro_torch.core.iterate.make_batched_solver`); a slot is either
bound to a ticket or dead (masked inactive: the batched kernel's blocks of
a dead slot return at once, so it costs no bytes, and the buffers keep one
width so a bucket's kernel is built once). Each :meth:`BatchEngine.run_chunk`
advances every live slot by up to ``policy.chunk`` steps, one launch per
step for the whole batch and no host synchronisation; between chunks the
host makes ONE read of the per-sample state (:meth:`BatchEngine.harvest`)
and

  * resolves finished slots (converged / quarantined / out-of-budget)
    with results or pointed errors,
  * fails live slots whose deadline passed (``DeadlineExceeded``),
  * refills freed slots from the queue (continuous batching: stragglers
    keep marching while new requests join at chunk boundaries),
  * applies the ``nan_at_step`` fault injection (poisons the scheduled
    sample's buffers so the device-side finite guard must catch it).

A result's fields stay on the device (a copy of the slot's fields, made
without a host sync); its error, reductions and iterations come from the
chunk's one read. Transient batch failures (``FaultPlan.on_batch``) are
retried with exponential backoff through ``fault.retry``.
"""
from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from .. import telemetry as _telemetry
from ..core import iterate
from ..distributed import fault
from . import errors
from .queue import Ticket

__all__ = ["BatchEngine", "BatchState"]


def _as_field(v, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """A request's field (a numpy array or a tensor) at the kernel's storage
    dtype on its device."""
    t = v if isinstance(v, torch.Tensor) else torch.as_tensor(np.asarray(v))
    return t.to(device=device, dtype=dtype)


class BatchState:
    """Slot table + device carry for one in-flight batch."""

    def __init__(self, engine: "BatchEngine", tickets: list[Ticket]):
        self.engine = engine
        pol = engine.policy
        kernel = engine.kernel
        b = pol.max_batch
        if len(tickets) > b:
            raise ValueError(f"{len(tickets)} tickets > max_batch {b}")
        self.slots: list[Optional[Ticket]] = list(tickets) + [None] * (b - len(tickets))
        t0 = tickets[0].request
        self.scalar_names = tuple(sorted(t0.scalars))
        self.bucket = t0.bucket
        for t in tickets:
            self._check_compatible(t)
        st, dev = kernel.ps.dtype, kernel.ps.device
        stacked = {n: torch.zeros((b, *v.shape), dtype=st, device=dev)
                   for n, v in t0.fields.items()}
        for i, t in enumerate(tickets):
            for n, v in t.request.fields.items():
                stacked[n][i].copy_(_as_field(v, st, dev))
        self.carry = iterate.init_batch_carry(
            kernel, stacked, until=pol.until,
            active=np.array([s is not None for s in self.slots]))
        self.injected = False       # nan_at_step fires once per batch
        self.started_at = time.monotonic()
        self.chunks = 0             # solver calls
        self.host_syncs = 0         # device-to-host reads of the state
        self.odd_host = np.zeros(b, bool)   # the parities of the last read

    def _check_compatible(self, t: Ticket):
        if t.request.bucket != self.bucket:
            raise ValueError(
                f"request {t.request.request_id!r} bucket does not match "
                "the batch (grid-bucketed queues should prevent this)")
        if tuple(sorted(t.request.scalars)) != self.scalar_names:
            raise ValueError(
                f"request {t.request.request_id!r} scalars "
                f"{tuple(sorted(t.request.scalars))} != batch scalars "
                f"{self.scalar_names}; one bucket must share scalar names")

    # -- slot views ----------------------------------------------------------
    @property
    def live(self) -> list[int]:
        return [i for i, s in enumerate(self.slots) if s is not None]

    @property
    def n_live(self) -> int:
        return len(self.live)

    def _vec(self, get, fill, dtype):
        return np.array([fill if s is None else get(s) for s in self.slots], dtype)

    def scalar_sets(self) -> list:
        """Each slot's scalars as the request gave them (None for a dead
        slot): a sample's parameters are evaluated from its own Python
        values, as its solo ``solve_until`` evaluates them."""
        return [None if s is None else dict(s.request.scalars) for s in self.slots]

    # -- refill --------------------------------------------------------------
    def bind(self, slot: int, ticket: Ticket) -> None:
        """Bind a fresh ticket to a freed slot: reset its per-sample state
        (fields at parity 0, error, steps, flags) without touching any
        other slot."""
        self._check_compatible(ticket)
        if self.slots[slot] is not None:
            raise ValueError(f"slot {slot} still bound")
        self.slots[slot] = ticket
        kernel = self.engine.kernel
        c = self.carry
        c.odd[slot] = False
        for n, v in ticket.request.fields.items():
            c.bufs[n][slot].copy_(_as_field(v, kernel.ps.dtype, kernel.ps.device))
        c.err[slot] = np.inf if self.engine.policy.until == "below" else -np.inf
        c.steps[slot] = 0
        c.active[slot] = True
        c.converged[slot] = False
        c.bad[slot] = False

    def release(self, slot: int) -> Ticket:
        t = self.slots[slot]
        self.slots[slot] = None
        self.carry.active[slot] = False
        return t

    def deactivate(self, slot: int) -> None:
        self.carry.active[slot] = False

    def poison(self, slot: int) -> None:
        """NaN the slot's buffers, both of each pair, so its current fields
        are NaN whatever its parity (fault injection: the finite guard in
        the device loop must detect and quarantine it)."""
        for v in self.carry.bufs.values():
            v[slot] = float("nan")
        self.injected = True

    def result_for(self, slot: int, state: dict) -> dict:
        """One finished slot's payload: its fields (device tensors, copied
        from its buffers at its parity), reductions, error and iterations
        from the chunk's read ``state``."""
        fields = self.carry.sample(slot, bool(self.odd_host[slot]))
        return {
            "fields": {n: v.clone() for n, v in fields.items()},
            "reds": {n: float(v[slot]) for n, v in state["reds"].items()},
            "err": float(state["err"][slot]),
            "iters": int(state["steps"][slot]),
        }


class BatchEngine:
    """Builds/caches the batched solver and advances BatchStates."""

    def __init__(self, kernel, policy):
        self.kernel = kernel
        self.policy = policy
        self._solver = iterate.batched_solver(
            kernel, check_every=policy.check_every, error=policy.error, until=policy.until)

    def start(self, tickets: list[Ticket]) -> BatchState:
        return BatchState(self, tickets)

    def run_chunk(self, state: BatchState) -> None:
        """One solver call of up to ``policy.chunk`` steps (one launch a
        step, no host synchronisation). A transient failure before the
        first launch is retried; the final one, when the retry budget is
        exhausted, is raised (the worker's breaker counts those). Only
        that part is retried: the solver moves the carry's buffers in
        place, so a chunk cut after a launch cannot be replayed."""
        pol = self.policy
        c = state.carry
        scal = state.scalar_sets()
        tol = state._vec(lambda s: s.request.tol, 0.0, np.float64)
        budget = state._vec(lambda s: s.request.max_iters, 0, np.int64)
        plan = fault.FaultPlan.active()
        calls = {"n": 0}

        def before_launch():
            calls["n"] += 1
            if plan is not None:
                plan.on_batch()

        col = _telemetry.get()
        with col.span("serve.chunk", live=state.n_live):
            fault.retry(before_launch, attempts=pol.retry_attempts,
                        backoff_s=pol.retry_backoff_s, exceptions=(fault.TransientIOError,))
            final = self._solver(c, scal, tol, budget, pol.chunk)
        if calls["n"] > 1:
            col.count("serve.batch_retries", calls["n"] - 1)
        state.carry = final
        state.chunks += 1

    # -- host-side pass between chunks --------------------------------------
    def read_state(self, state: BatchState) -> dict:
        """The chunk boundary's ONE host sync: every slot's flags, parity,
        steps, error and reductions in a single device-to-host copy."""
        host = state.carry.read()
        state.host_syncs += 1
        _telemetry.get().count("serve.host_syncs", 1)
        state.odd_host = host["odd"]
        return host

    def harvest(self, state: BatchState) -> list[int]:
        """Resolve finished slots; fail expired live slots; apply the
        nan_at_step injection. Returns the freed slot indices."""
        col = _telemetry.get()
        host = self.read_state(state)
        active, converged, bad, steps = (host[k] for k in
                                         ("active", "converged", "bad", "steps"))
        now = time.monotonic()
        freed: list[int] = []

        plan = fault.FaultPlan.active()
        if plan is not None and not state.injected:
            victim = plan.serve_nan_due(int(steps[state.live[0]]) if state.live else 0)
            if victim is not None and victim < len(state.slots) \
                    and state.slots[victim] is not None and active[victim]:
                state.poison(victim)
                col.event("serve.fault_injected", kind="nan", slot=victim,
                          request=state.slots[victim].request.request_id)

        for i, ticket in enumerate(state.slots):
            if ticket is None:
                continue
            if not active[i]:
                payload = state.result_for(i, host) if converged[i] and not bad[i] else None
                t = state.release(i)
                freed.append(i)
                if bad[i]:
                    col.count("serve.quarantined", 1)
                    t.fail(errors.SampleQuarantined(t.request.request_id, int(steps[i])))
                elif converged[i]:
                    col.count("serve.completed", 1)
                    t.resolve(payload)
                else:
                    col.count("serve.budget_exhausted", 1)
                    t.fail(errors.BudgetExhausted(t.request.request_id, int(steps[i]),
                                                  float(host["err"][i])))
            elif ticket.expired(now):
                state.deactivate(i)
                t = state.release(i)
                freed.append(i)
                col.count("serve.expired", 1, where="in_batch")
                t.fail(errors.DeadlineExceeded(
                    t.request.request_id, t.request.deadline_s, "in_batch"))
        return freed

    def expire_all(self, state: BatchState, where: str) -> None:
        """Batch-level timeout: fail every still-live slot."""
        col = _telemetry.get()
        for i in list(state.live):
            state.deactivate(i)
            t = state.release(i)
            col.count("serve.expired", 1, where=where)
            t.fail(errors.DeadlineExceeded(
                t.request.request_id,
                t.request.deadline_s
                if t.request.deadline_s is not None
                else self.policy.batch_timeout_s, where))
