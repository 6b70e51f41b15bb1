"""Serving policy: every tunable of the hardened serving path in one
frozen dataclass, so a server's behavior is one printable object."""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Union

__all__ = ["ServePolicy"]


@dataclasses.dataclass(frozen=True)
class ServePolicy:
    """Knobs for :class:`~repro_torch.serve.server.SimulationServer`.

    Batching — ``max_batch`` is the slot count of the device batch (its
    buffers are allocated once per batch at this width; partial batches
    run with dead slots masked inactive, which the batched kernel skips).
    ``chunk_steps`` is how many steps each solver call advances before the
    host looks again — the refill/deadline/quarantine cadence. It is
    rounded up to a whole number of ``check_every`` blocks.
    ``collect_window_s`` is how long a worker waits to aggregate a fuller
    batch before launching a partial one.

    Robustness — ``batch_timeout_s`` bounds one batch's wall time: when
    it expires, still-running samples fail with a pointed
    ``DeadlineExceeded`` rather than holding the worker. ``retry_*``
    drive :func:`repro_torch.distributed.fault.retry` around transiently
    failing batch executions. ``breaker_threshold`` consecutive
    non-transient batch failures trip the worker's circuit breaker: its
    in-flight requests re-queue and the supervisor replaces the worker
    (up to ``max_worker_restarts``).
    """

    # batching
    max_batch: int = 8
    chunk_steps: int = 64
    check_every: int = 4
    collect_window_s: float = 0.02
    queue_capacity: int = 64

    # solve semantics (forwarded to the batched solver)
    error: Union[str, Callable, None] = None
    until: str = "below"

    # robustness
    batch_timeout_s: Optional[float] = None
    retry_attempts: int = 3
    retry_backoff_s: float = 0.05
    breaker_threshold: int = 3
    max_worker_restarts: int = 2
    heartbeat_dir: Optional[str] = None
    heartbeat_timeout_s: float = 60.0

    def __post_init__(self):
        if self.max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {self.max_batch}")
        if self.check_every < 1:
            raise ValueError(
                f"check_every must be >= 1, got {self.check_every}")
        if self.chunk_steps < 1:
            raise ValueError(
                f"chunk_steps must be >= 1, got {self.chunk_steps}")
        if self.retry_attempts < 1:
            raise ValueError(
                f"retry_attempts must be >= 1, got {self.retry_attempts}")

    @property
    def chunk(self) -> int:
        """chunk_steps rounded up to whole check_every blocks."""
        m = self.check_every
        return ((self.chunk_steps + m - 1) // m) * m
