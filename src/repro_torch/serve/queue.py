"""Bounded request queue with backpressure, grid bucketing and deadlines.

Admission is synchronous and strict: ``submit`` either returns a
:class:`Ticket` (the request IS in the queue) or raises a typed
rejection (:class:`~repro_torch.serve.errors.QueueFull` /
:class:`~repro_torch.serve.errors.ServerClosed`) — there is no silent drop
and no unbounded buffering. The bound is the backpressure signal: a
full queue means the fleet is saturated and the caller should shed or
slow down, not that the server will quietly queue into OOM.

Requests are bucketed by field signature (shapes + dtypes, the same for
a numpy array and a torch tensor of one shape and dtype): a batch must
stack samples on a leading axis, so only same-bucket requests can share
a launch. ``take_batch`` pops up to ``max_batch`` requests from
the oldest non-empty bucket (FIFO within a bucket), skipping — and
immediately failing — requests whose deadline already passed while
queued (a request that cannot make its deadline must not occupy a
batch slot).

``requeue`` puts in-flight requests back at the FRONT of their bucket
(they have already waited once) — the path a worker death takes.
"""
from __future__ import annotations

import itertools
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Mapping, Optional

from .. import telemetry as _telemetry
from ..distributed import fault
from . import errors

__all__ = ["SolveRequest", "Ticket", "RequestQueue", "bucket_key"]

_ids = itertools.count()


def _dtype_name(v) -> str:
    """A field's dtype by name, ``float32`` for a numpy array and a torch
    tensor alike (a torch dtype prints as ``torch.float32``)."""
    dt = getattr(v, "dtype", None)
    return type(v).__name__ if dt is None else str(dt).removeprefix("torch.")


def bucket_key(fields: Mapping[str, Any]) -> tuple:
    """The batch-compatibility signature of a request's fields."""
    return tuple(sorted(
        (n, tuple(int(d) for d in getattr(v, "shape", ())), _dtype_name(v))
        for n, v in fields.items()))


@dataclass
class SolveRequest:
    """One user solve: initial fields + per-request scalars + policy."""

    fields: Mapping[str, Any]
    scalars: Mapping[str, Any] = field(default_factory=dict)
    tol: float = 1e-5
    max_iters: int = 1000
    deadline_s: Optional[float] = None     # wall seconds from submit
    request_id: str = ""

    def __post_init__(self):
        if not self.request_id:
            self.request_id = f"req-{next(_ids)}"

    @property
    def bucket(self) -> tuple:
        # scalar NAMES join the key: a batch stacks per-request scalar
        # values into (B,) vectors, so requests with different scalar
        # sets can never share a launch
        return (bucket_key(self.fields), tuple(sorted(self.scalars)))


@dataclass
class Ticket:
    """The caller's handle: resolves to a result dict or a ServeError.

    ``wait`` blocks; ``result()`` returns the payload or raises the
    pointed failure. One ticket resolves exactly once."""

    request: SolveRequest
    submitted_at: float = field(default_factory=time.monotonic)
    _done: threading.Event = field(default_factory=threading.Event)
    _result: Any = None
    _error: Optional[Exception] = None

    @property
    def deadline_at(self) -> Optional[float]:
        if self.request.deadline_s is None:
            return None
        return self.submitted_at + self.request.deadline_s

    def expired(self, now: Optional[float] = None) -> bool:
        d = self.deadline_at
        return d is not None and (time.monotonic() if now is None
                                  else now) >= d

    def resolve(self, result: Any) -> None:
        if not self._done.is_set():
            self._result = result
            self._done.set()

    def fail(self, exc: Exception) -> None:
        if not self._done.is_set():
            self._error = exc
            self._done.set()

    @property
    def done(self) -> bool:
        return self._done.is_set()

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self._done.wait(timeout)

    def result(self, timeout: Optional[float] = None) -> Any:
        if not self._done.wait(timeout):
            raise TimeoutError(
                f"request {self.request.request_id!r} still in flight")
        if self._error is not None:
            raise self._error
        return self._result


class RequestQueue:
    """Bounded, bucketed FIFO with typed shed."""

    def __init__(self, capacity: int = 64):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self._buckets: dict[tuple, list[Ticket]] = {}
        self._order: list[tuple] = []       # bucket arrival order
        self._lock = threading.Lock()
        self._not_empty = threading.Condition(self._lock)
        self._closed = False

    # -- admission -----------------------------------------------------------
    def __len__(self) -> int:
        with self._lock:
            return sum(len(b) for b in self._buckets.values())

    def submit(self, request: SolveRequest) -> Ticket:
        """Admit or shed. Returns the ticket; raises QueueFull /
        ServerClosed (the caller keeps the request — nothing is lost)."""
        col = _telemetry.get()
        plan = fault.FaultPlan.active()
        with self._lock:
            if self._closed:
                col.count("serve.rejected", 1, reason="closed")
                raise errors.ServerClosed(request.request_id)
            depth = sum(len(b) for b in self._buckets.values())
            if depth >= self.capacity or (plan is not None
                                          and plan.on_submit()):
                col.count("serve.shed", 1)
                col.gauge("serve.queue_depth", depth)
                raise errors.QueueFull(request.request_id, self.capacity)
            t = Ticket(request)
            key = request.bucket
            if key not in self._buckets:
                self._buckets[key] = []
                self._order.append(key)
            self._buckets[key].append(t)
            col.count("serve.admitted", 1)
            col.gauge("serve.queue_depth", depth + 1)
            self._not_empty.notify_all()
            return t

    def requeue(self, tickets: list[Ticket]) -> None:
        """Put in-flight tickets back at the FRONT of their buckets
        (worker death path). Already-resolved tickets are skipped."""
        col = _telemetry.get()
        with self._lock:
            for t in reversed(tickets):
                if t.done:
                    continue
                key = t.request.bucket
                if key not in self._buckets:
                    self._buckets[key] = []
                    self._order.insert(0, key)
                self._buckets[key].insert(0, t)
                col.count("serve.requeued", 1)
            self._not_empty.notify_all()

    # -- dispatch ------------------------------------------------------------
    def take_batch(self, max_batch: int, timeout: Optional[float] = None,
                   should_stop: Optional[Callable[[], bool]] = None
                   ) -> list[Ticket]:
        """Pop up to ``max_batch`` same-bucket tickets (oldest bucket
        first, FIFO within it). Blocks up to ``timeout`` for work;
        returns [] on timeout or stop. Queue-expired tickets are failed
        here — with a pointed DeadlineExceeded — and don't occupy
        slots."""
        deadline = None if timeout is None else time.monotonic() + timeout
        expired: list[Ticket] = []
        try:
            with self._not_empty:
                while True:
                    now = time.monotonic()
                    batch = self._pop_locked(max_batch, now, expired)
                    if batch:
                        return batch
                    if should_stop is not None and should_stop():
                        return []
                    if self._closed and not self._buckets:
                        return []
                    wait = (None if deadline is None
                            else max(0.0, deadline - now))
                    if wait == 0.0:
                        return []
                    self._not_empty.wait(0.05 if wait is None
                                         else min(wait, 0.05))
                    if deadline is not None and time.monotonic() >= deadline:
                        return []
        finally:
            col = _telemetry.get()
            for t in expired:
                col.count("serve.expired", 1, where="queued")
                t.fail(errors.DeadlineExceeded(
                    t.request.request_id, t.request.deadline_s, "queued"))

    def _pop_locked(self, max_batch: int, now: float,
                    expired: list[Ticket]) -> list[Ticket]:
        for key in list(self._order):
            bucket = self._buckets.get(key, [])
            live: list[Ticket] = []
            keep: list[Ticket] = []
            for t in bucket:
                if t.done:
                    continue                    # resolved elsewhere
                if t.expired(now):
                    expired.append(t)
                elif len(live) < max_batch:
                    live.append(t)
                else:
                    keep.append(t)
            if keep:
                self._buckets[key] = keep
            else:
                self._buckets.pop(key, None)
                self._order.remove(key)
            if live:
                _telemetry.get().gauge(
                    "serve.queue_depth",
                    sum(len(b) for b in self._buckets.values()))
                return live
        return []

    # -- lifecycle -----------------------------------------------------------
    def close(self, drain: bool = True) -> None:
        """Stop admissions. ``drain=False`` fails everything queued."""
        with self._lock:
            self._closed = True
            if not drain:
                for bucket in self._buckets.values():
                    for t in bucket:
                        t.fail(errors.ServerClosed(t.request.request_id))
                self._buckets.clear()
                self._order.clear()
            self._not_empty.notify_all()

    @property
    def closed(self) -> bool:
        return self._closed
