"""repro_torch.serve — the hardened simulation-serving layer of the port.

Accepts many independent solve requests (per-request scalars and
initial conditions on a common grid bucket) and runs them as
dynamically assembled, continuously refilled device batches through the
batch-axis solver (:func:`repro_torch.core.iterate.solve_batch`
machinery: one launch of the generated kernel per step for the whole
batch), wrapped in production robustness: a bounded queue with
backpressure and typed load-shedding, per-request deadlines and
batch-level timeouts, retry-with-backoff for transient batch failures, a
device-resident NaN/Inf guard that quarantines diverging samples while
the rest of the batch completes, and a worker circuit-breaker/supervisor
layer that re-queues in-flight requests when a worker trips or dies.

Entry points::

    from repro_torch.serve import SimulationServer, ServePolicy, SolveRequest
    python -m repro_torch.serve --demo [--device cpu]   # self-contained demo

Failure taxonomy (all carry request_id): QueueFull / ServerClosed
(shed at admission), DeadlineExceeded, SampleQuarantined,
BudgetExhausted, WorkerDied.
"""
from .errors import (BudgetExhausted, DeadlineExceeded, QueueFull,
                     RequestRejected, SampleQuarantined, ServeError,
                     ServerClosed, WorkerDied)
from .policy import ServePolicy
from .pool import ProcessWorkerPool, ProcTicket
from .queue import RequestQueue, SolveRequest, Ticket, bucket_key
from .server import SimulationServer

__all__ = [
    "SimulationServer", "ServePolicy", "SolveRequest", "Ticket",
    "RequestQueue", "bucket_key",
    "ProcessWorkerPool", "ProcTicket",
    "ServeError", "RequestRejected", "QueueFull", "ServerClosed",
    "DeadlineExceeded", "SampleQuarantined", "BudgetExhausted",
    "WorkerDied",
]
