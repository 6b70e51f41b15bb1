"""SimulationServer: the hardened front door around the batch engine.

``submit`` admits (or sheds) a request and returns a ticket; a pool of
workers drains the queue through fixed-width device batches; a
supervisor thread watches worker health and replaces workers that trip
their circuit breaker or die, re-queuing their in-flight requests — a
request admitted to the queue always resolves, with a result or a
pointed error, even across a worker death.

Per-request latency is recorded as a ``serve.request`` span (queue wait
included) and the counters named in the README's Serving section tell
the load story: admitted/shed/completed/quarantined/expired/requeued.

Usage::

    server = SimulationServer(kernel, ServePolicy(max_batch=8))
    with server:
        t = server.submit(SolveRequest(fields={...}, scalars={"dt": 0.1},
                                       tol=1e-5, max_iters=500,
                                       deadline_s=2.0))
        out = t.result(timeout=10.0)   # or raises the pointed failure
"""
from __future__ import annotations

import threading
import time
from typing import Optional

from .. import telemetry as _telemetry
from .engine import BatchEngine
from .policy import ServePolicy
from .queue import RequestQueue, SolveRequest, Ticket
from .worker import Worker

__all__ = ["SimulationServer"]


class SimulationServer:
    def __init__(self, kernel, policy: Optional[ServePolicy] = None,
                 workers: int = 1):
        self.policy = policy or ServePolicy()
        self.engine = BatchEngine(kernel, self.policy)
        self.queue = RequestQueue(self.policy.queue_capacity)
        self._workers: list[Worker] = []
        self._n_workers = workers
        self._restarts = 0
        self._seq = 0
        self._closing = threading.Event()
        self._supervisor: Optional[threading.Thread] = None
        self._started = False

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "SimulationServer":
        if self._started:
            return self
        self._started = True
        for _ in range(self._n_workers):
            self._spawn_worker()
        self._supervisor = threading.Thread(target=self._supervise,
                                            name="serve-supervisor",
                                            daemon=True)
        self._supervisor.start()
        return self

    def _spawn_worker(self) -> Worker:
        w = Worker(f"serve-worker-{self._seq}", self.engine, self.queue,
                   rank=self._seq)
        self._seq += 1
        self._workers.append(w)
        w.start()
        _telemetry.get().event("serve.worker_started", worker=w.name)
        return w

    def _supervise(self) -> None:
        """Replace tripped/dead workers (bounded restarts), re-queuing
        their unresolved in-flight tickets first."""
        col = _telemetry.get()
        while not self._closing.is_set():
            for w in list(self._workers):
                if w.alive:
                    continue
                self._workers.remove(w)
                orphans = w.in_flight()
                if orphans:
                    self.queue.requeue(orphans)
                done_reason = "tripped" if w.tripped else "died"
                col.event("serve.worker_ejected", worker=w.name,
                          reason=done_reason, requeued=len(orphans))
                if (not self.queue.closed
                        and self._restarts
                        < self.policy.max_worker_restarts):
                    self._restarts += 1
                    col.count("serve.worker_restarts", 1)
                    self._spawn_worker()
            self._closing.wait(0.05)

    def close(self, drain: bool = True, timeout: float = 30.0) -> None:
        """Stop admissions; ``drain=True`` lets queued work finish."""
        self.queue.close(drain=drain)
        deadline = time.monotonic() + timeout
        if drain:
            while len(self.queue) and time.monotonic() < deadline:
                time.sleep(0.01)
        self._closing.set()
        for w in self._workers:
            w.stop(join=False)
        for w in self._workers:
            if w.alive:
                w._thread.join(timeout=max(0.0,
                                           deadline - time.monotonic()))
        if self._supervisor is not None:
            self._supervisor.join(timeout=1.0)
        # anything still unresolved after shutdown gets a pointed error
        for w in self._workers:
            for t in w.in_flight():
                from . import errors
                t.fail(errors.WorkerDied(t.request.request_id,
                                         "server shut down"))

    def __enter__(self) -> "SimulationServer":
        return self.start()

    def __exit__(self, *exc) -> bool:
        self.close()
        return False

    # -- API -----------------------------------------------------------------
    def submit(self, request: SolveRequest) -> Ticket:
        """Admit or shed (raises QueueFull/ServerClosed). The returned
        ticket's latency span covers queue wait + compute."""
        if not self._started:
            self.start()
        t = self.queue.submit(request)
        col = _telemetry.get()
        if col.enabled:
            wall0, mono0 = time.time(), time.monotonic()
            rid = request.request_id

            def finish(_t=t):
                col.span_end("serve.request", wall0,
                             time.monotonic() - mono0,
                             {"request": rid,
                              "outcome": ("error:" + type(_t._error)
                                          .__name__ if _t._error
                                          else "ok")})
            _spy_on_resolve(t, finish)
        return t

    def solve(self, request: SolveRequest,
              timeout: Optional[float] = None):
        """Synchronous convenience: submit + result."""
        return self.submit(request).result(timeout)

    @property
    def workers_alive(self) -> int:
        return sum(1 for w in self._workers if w.alive)


def _spy_on_resolve(ticket: Ticket, callback) -> None:
    """Invoke ``callback`` once when the ticket resolves (telemetry)."""
    done = ticket._done
    orig_set = done.set

    def set_and_report():
        orig_set()
        try:
            callback()
        except Exception:
            pass
    done.set = set_and_report
