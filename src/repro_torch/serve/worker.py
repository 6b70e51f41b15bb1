"""The serving worker: one thread draining the queue through the engine.

A worker's loop: collect a batch (waiting up to ``collect_window_s`` to
aggregate), run chunks with harvest/refill between them (continuous
batching), and repeat. Its robustness duties:

  * every completed batch bumps a :class:`repro_torch.distributed.fault.
    Heartbeat` (when ``policy.heartbeat_dir`` is set) — the supervisor's
    liveness signal across processes;
  * a batch whose retries are exhausted counts one breaker strike;
    ``policy.breaker_threshold`` consecutive strikes TRIP the worker: it
    re-queues all in-flight tickets (none are lost) and exits with
    ``tripped=True`` so the supervisor can replace it;
  * ``FaultPlan.worker_batch_done`` is called after each batch — the
    ``kill_worker_after`` injection dies there, leaving in-flight
    tickets for the supervisor to recover from ``in_flight()``;
  * a batch-level timeout (``policy.batch_timeout_s``) bounds wall time
    per batch so a pathological workload cannot wedge the worker.
"""
from __future__ import annotations

import threading
import time
from typing import Optional

from .. import telemetry as _telemetry
from ..distributed import fault
from .engine import BatchEngine, BatchState
from .queue import RequestQueue, Ticket

__all__ = ["Worker"]


class Worker:
    def __init__(self, name: str, engine: BatchEngine, queue: RequestQueue,
                 rank: int = 0):
        self.name = name
        self.engine = engine
        self.queue = queue
        self.policy = engine.policy
        self._state: Optional[BatchState] = None
        self._state_lock = threading.Lock()
        self._stop = threading.Event()
        self.tripped = False
        self.strikes = 0
        self.batches_done = 0
        self.heartbeat = (fault.Heartbeat(self.policy.heartbeat_dir,
                                          rank=rank,
                                          timeout_s=self.policy
                                          .heartbeat_timeout_s)
                          if self.policy.heartbeat_dir else None)
        self._thread = threading.Thread(target=self._run, name=name,
                                        daemon=True)

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "Worker":
        self._thread.start()
        return self

    def stop(self, join: bool = True) -> None:
        self._stop.set()
        if join and self._thread.is_alive():
            self._thread.join(timeout=30.0)

    @property
    def alive(self) -> bool:
        return self._thread.is_alive()

    def in_flight(self) -> list[Ticket]:
        """Unresolved tickets currently bound to this worker's batch —
        what the supervisor re-queues when the worker dies."""
        with self._state_lock:
            if self._state is None:
                return []
            return [t for t in self._state.slots
                    if t is not None and not t.done]

    # -- main loop -----------------------------------------------------------
    def _run(self) -> None:
        col = _telemetry.get()
        while not self._stop.is_set():
            tickets = self.queue.take_batch(
                self.policy.max_batch,
                timeout=self.policy.collect_window_s,
                should_stop=self._stop.is_set)
            if not tickets:
                if self.queue.closed and len(self.queue) == 0:
                    return
                continue
            ok = self._serve_batch(tickets)
            if ok:
                self.strikes = 0
            else:
                self.strikes += 1
                col.count("serve.breaker_strikes", 1)
                if self.strikes >= self.policy.breaker_threshold:
                    # in-flight tickets were already re-queued by the
                    # failing _serve_batch; just hand the slot back
                    self.tripped = True
                    col.event("serve.breaker_tripped", worker=self.name,
                              strikes=self.strikes)
                    return
            plan = fault.FaultPlan.active()
            if plan is not None:
                plan.worker_batch_done()

    def _serve_batch(self, tickets: list[Ticket]) -> bool:
        """One batch to completion (with refill). True on success."""
        col = _telemetry.get()
        pol = self.policy
        try:
            state = self.engine.start(tickets)
        except Exception as e:
            col.count("serve.batch_failures", 1)
            col.event("serve.batch_failed", worker=self.name,
                      error=type(e).__name__, detail=str(e)[:200])
            self.queue.requeue([t for t in tickets if not t.done])
            return False
        with self._state_lock:
            self._state = state
        try:
            while state.n_live and not self._stop.is_set():
                if (pol.batch_timeout_s is not None
                        and time.monotonic() - state.started_at
                        > pol.batch_timeout_s):
                    self.engine.expire_all(state, "batch_timeout")
                    break
                self.engine.run_chunk(state)
                freed = self.engine.harvest(state)
                if freed:
                    # continuous batching: freed slots refill from the
                    # same bucket without waiting for the batch to drain
                    more = self.queue.take_batch(len(freed), timeout=0.0)
                    for slot, t in zip(freed, more):
                        if t.request.bucket == state.bucket:
                            state.bind(slot, t)
                            col.count("serve.refilled", 1)
                        else:       # rare cross-bucket race: hand back
                            self.queue.requeue([t])
            self.batches_done += 1
            col.count("serve.batches", 1)
            if self.heartbeat is not None:
                self.heartbeat.bump(self.batches_done)
            return True
        except Exception as e:
            # retries exhausted or a non-transient failure: the batch is
            # lost but its REQUESTS are not — unresolved tickets go back
            # to the front of the queue for the next worker/attempt
            col.count("serve.batch_failures", 1)
            col.event("serve.batch_failed", worker=self.name,
                      error=type(e).__name__, detail=str(e)[:200])
            pending = [t for t in state.slots
                       if t is not None and not t.done]
            if pending:
                self.queue.requeue(pending)
            return False
        finally:
            with self._state_lock:
                self._state = None
