"""Pointed, typed failure reasons for the serving layer.

Every way a request can fail maps to ONE exception class carrying the
request id and enough context to act on — "your sample went NaN at step
24" is a different operator page than "the queue was full". A request is
never lost silently: it resolves with a result or with exactly one of
these.
"""
from __future__ import annotations

__all__ = [
    "ServeError", "RequestRejected", "QueueFull", "ServerClosed",
    "DeadlineExceeded", "SampleQuarantined", "BudgetExhausted",
    "WorkerDied",
]


class ServeError(RuntimeError):
    """Base class; carries ``request_id``."""

    reason = "error"

    def __init__(self, request_id: str, msg: str):
        self.request_id = request_id
        super().__init__(msg)


class RequestRejected(ServeError):
    """Admission refused — the request never entered the queue."""

    reason = "rejected"


class QueueFull(RequestRejected):
    """Load shed: the bounded queue was at capacity (backpressure —
    resubmit later or raise the queue bound)."""

    reason = "queue_full"

    def __init__(self, request_id: str, capacity: int):
        self.capacity = capacity
        super().__init__(
            request_id,
            f"request {request_id!r} shed: queue at capacity {capacity}")


class ServerClosed(RequestRejected):
    """Admission after shutdown began."""

    reason = "closed"

    def __init__(self, request_id: str):
        super().__init__(request_id,
                         f"request {request_id!r} rejected: server closed")


class DeadlineExceeded(ServeError):
    """The request's deadline passed before it finished (it may have
    expired in the queue or mid-batch; ``where`` says which)."""

    reason = "deadline"

    def __init__(self, request_id: str, deadline_s: float, where: str):
        self.deadline_s = deadline_s
        self.where = where
        super().__init__(
            request_id,
            f"request {request_id!r} exceeded its {deadline_s:.3f}s "
            f"deadline ({where})")


class SampleQuarantined(ServeError):
    """The device-side finite guard tripped for this sample: its field
    went NaN/Inf at the reported step. The rest of the batch was
    unaffected — check the request's scalars (unstable dt?) or initial
    condition."""

    reason = "quarantined"

    def __init__(self, request_id: str, step: int):
        self.step = step
        super().__init__(
            request_id,
            f"request {request_id!r} quarantined: non-finite field "
            f"detected at step {step} (NaN/Inf guard). The remaining "
            "batch completed; check this request's scalars/IC")


class BudgetExhausted(ServeError):
    """The sample ran out of its iteration budget without converging
    (and without going non-finite)."""

    reason = "budget"

    def __init__(self, request_id: str, iters: int, err: float):
        self.iters = iters
        self.err = err
        super().__init__(
            request_id,
            f"request {request_id!r} did not converge in {iters} steps "
            f"(final err {err:.3e})")


class WorkerDied(ServeError):
    """The worker processing this request died and the request could
    not be re-queued (retries/requeues exhausted)."""

    reason = "worker_died"

    def __init__(self, request_id: str, detail: str = ""):
        super().__init__(
            request_id,
            f"request {request_id!r} lost its worker"
            + (f": {detail}" if detail else ""))
