"""The telemetry `Collector`: counters, gauges, histograms, spans, events.

Two hard rules keep this subsystem honest about the engine it measures:

1. **Disabled is a true no-op.** :data:`NULL` is a process-wide singleton
   whose every method is an empty function and whose ``span()`` returns a
   shared reusable null context manager: no allocation, no branching
   beyond one attribute call at each instrumentation site. No file is
   opened, nothing is imported lazily on the hot path.

2. **Nothing here reads the device on its own.** Instrumentation sites
   emit only from host-side control flow (chunk boundaries, checkpoint
   writers) and turn a device value into a number only where the caller
   already synchronises with the card. A solve makes the same launches and
   the same host syncs with telemetry on or off.

Events stream to a JSONL file as they happen (one JSON object per line,
flushed per event; events are rare: chunk boundaries, saves, decisions).
Emission is lock-guarded because the async checkpoint writer reports from
its background thread. The schema is documented and enforced by
:mod:`repro_torch.telemetry.schema`.

A third rule: **telemetry must never kill the solve it observes.** The
JSONL writer is plumbing on a filesystem that can hiccup (flaky NFS, full
disk, an injected ``REPRO_FAULT_PLAN`` transient-IO budget), so every file
write runs through :func:`repro_torch.distributed.fault.retry` and, when
the retries are exhausted, degrades to dropping THAT line: the record
stays in memory, the ``telemetry.dropped_records`` counter ticks, and the
caller never sees the exception. Because ``fault.retry`` itself counts its
retries through this collector, the write path keeps a thread-local
reentrancy guard: nested emissions defer their lines and are flushed
best-effort after the outer write completes (no deadlock on the
non-reentrant lock, no unbounded recursion while the filesystem is down).
"""
from __future__ import annotations

import json
import os
import threading
import time
from typing import Optional

SCHEMA_VERSION = 1

__all__ = ["Collector", "NullCollector", "NULL", "SCHEMA_VERSION"]


class _SinkClosed(Exception):
    """Internal: the JSONL file handle was closed mid-write (shutdown
    race). NOT an OSError, so fault.retry does not retry or count it."""


class _NullSpan:
    """Reusable do-nothing context manager (shared instance, zero alloc)."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class NullCollector:
    """The disabled-mode singleton: every method is a no-op."""

    __slots__ = ()
    enabled = False
    path = None

    def count(self, name, value=1, **labels):
        pass

    def gauge(self, name, value, **labels):
        pass

    def observe(self, name, value, **labels):
        pass

    def event(self, name, **attrs):
        pass

    def span(self, name, **attrs):
        return _NULL_SPAN

    def span_end(self, name, wall_start, dur_s, attrs=None):
        pass

    def flush(self):
        pass

    def close(self):
        pass


NULL = NullCollector()


class _Span:
    """Context manager emitted by :meth:`Collector.span`: wall-clock start
    plus a monotonic duration, recorded on exit."""

    __slots__ = ("_col", "_name", "_attrs", "_t0", "_w0")

    def __init__(self, col: "Collector", name: str, attrs: dict):
        self._col = col
        self._name = name
        self._attrs = attrs

    def __enter__(self):
        self._w0 = time.time()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        dur = time.perf_counter() - self._t0
        if exc_type is not None:
            self._attrs = dict(self._attrs, error=exc_type.__name__)
        self._col.span_end(self._name, self._w0, dur, self._attrs)
        return False


def _jsonable(v):
    """Coerce attribute values to JSON-safe scalars (0-d tensors and numpy
    types arrive here; anything exotic degrades to repr)."""
    if v is None or isinstance(v, (bool, int, float, str)):
        return v
    if isinstance(v, (tuple, list)):
        return [_jsonable(x) for x in v]
    if isinstance(v, dict):
        return {str(k): _jsonable(x) for k, x in v.items()}
    try:
        import numpy as np

        if isinstance(v, np.integer):
            return int(v)
        if isinstance(v, (np.floating, np.ndarray)) and getattr(v, "size", 2) == 1:
            return float(v)
    except Exception:
        pass
    try:
        return float(v)  # a one-element tensor: the caller's sync reads it
    except Exception:
        return repr(v)


class Collector:
    """An enabled telemetry collector.

    ``path=None`` keeps events in memory only (``.records``), the mode
    tests and ad-hoc benchmarks use; a path streams JSONL write-through.
    """

    enabled = True

    # retry policy for JSONL writes: quick, bounded. Telemetry is not
    # worth stalling a solve for; a line that cannot land in ~3 tries on
    # a ~10ms backoff is dropped (counted) rather than waited on
    IO_ATTEMPTS = 3
    IO_BACKOFF_S = 0.01
    IO_MAX_BACKOFF_S = 0.1

    def __init__(self, path: Optional[str] = None, *,
                 meta: Optional[dict] = None, rank: Optional[int] = None):
        self.path = path
        self.rank = rank       # stamps every record (multi-process streams)
        self.records: list[dict] = []
        self.counters: dict[tuple, float] = {}
        self.gauges: dict[tuple, float] = {}
        self.hists: dict[tuple, list[float]] = {}
        self._lock = threading.Lock()
        self._tls = threading.local()
        self._fh = None
        if path:
            d = os.path.dirname(path)
            if d:
                os.makedirs(d, exist_ok=True)
            from ..distributed import fault  # lazy: fault imports telemetry

            try:
                self._fh = fault.retry(
                    lambda: (fault.FaultPlan.active_on_io(path),
                             open(path, "a"))[1],
                    attempts=self.IO_ATTEMPTS, backoff_s=self.IO_BACKOFF_S,
                    max_backoff_s=self.IO_MAX_BACKOFF_S)
            except OSError:
                # the sink never comes up: degrade to memory-only rather
                # than kill the caller; every would-be line counts dropped
                self._fh = None
        head = {"kind": "meta", "ts": time.time(), "schema": SCHEMA_VERSION,
                "pid": os.getpid()}
        if path and self._fh is None:
            head["sink_degraded"] = True
        head.update({k: _jsonable(v) for k, v in (meta or {}).items()})
        self._emit(head)

    # -- emission ------------------------------------------------------------
    def _emit(self, rec: dict):
        if self.rank is not None and "rank" not in rec:
            rec["rank"] = self.rank
        with self._lock:
            self.records.append(rec)
            fh = self._fh
        if self.path is None:
            return
        line = json.dumps(rec) + "\n"
        if fh is None:
            self._drop()
            return
        tls = self._tls
        if getattr(tls, "writing", False):
            # nested emission from inside the guarded write (fault.retry
            # counting its own retries): defer; the outer write flushes
            tls.pending.append(line)
            return
        tls.writing, tls.pending = True, []
        try:
            self._write_guarded(line)
            while tls.pending:
                self._write_guarded(tls.pending.pop(0))
        finally:
            tls.writing = False

    def _write_guarded(self, line: str):
        """One retried JSONL write; exhaustion drops the line (counted),
        never raises."""
        from ..distributed import fault  # lazy: fault imports telemetry

        def write():
            fault.FaultPlan.active_on_io(self.path)
            with self._lock:
                if self._fh is None:
                    raise _SinkClosed  # closed under us: drop silently
                self._fh.write(line)
                self._fh.flush()

        try:
            fault.retry(write, attempts=self.IO_ATTEMPTS,
                        backoff_s=self.IO_BACKOFF_S,
                        max_backoff_s=self.IO_MAX_BACKOFF_S)
        except _SinkClosed:
            pass
        except OSError:
            self._drop()

    def _drop(self):
        """Account one dropped JSONL line. In memory only BY DESIGN: a drop
        means the sink is failing, so emitting a record about it would
        recurse into the same failing write."""
        with self._lock:
            k = ("telemetry.dropped_records", ())
            self.counters[k] = self.counters.get(k, 0) + 1

    @property
    def dropped_records(self) -> int:
        return int(self.counters.get(("telemetry.dropped_records", ()), 0))

    @staticmethod
    def _key(name: str, labels: dict) -> tuple:
        return (name, tuple(sorted(labels.items()))) if labels else (name, ())

    def count(self, name: str, value: float = 1, **labels):
        """Increment a monotonic counter; the JSONL line records the
        increment, the in-memory total feeds the Prometheus export."""
        labels = {k: _jsonable(v) for k, v in labels.items()}
        k = self._key(name, labels)
        with self._lock:
            self.counters[k] = self.counters.get(k, 0) + value
        rec = {"kind": "counter", "ts": time.time(), "name": name,
               "value": _jsonable(value)}
        if labels:
            rec["labels"] = labels
        self._emit(rec)

    def gauge(self, name: str, value: float, **labels):
        """Set a point-in-time value (last write wins in exports)."""
        labels = {k: _jsonable(v) for k, v in labels.items()}
        with self._lock:
            self.gauges[self._key(name, labels)] = _jsonable(value)
        rec = {"kind": "gauge", "ts": time.time(), "name": name,
               "value": _jsonable(value)}
        if labels:
            rec["labels"] = labels
        self._emit(rec)

    def observe(self, name: str, value: float, **labels):
        """Record one histogram observation (summarized at export time)."""
        labels = {k: _jsonable(v) for k, v in labels.items()}
        k = self._key(name, labels)
        with self._lock:
            self.hists.setdefault(k, []).append(float(value))
        rec = {"kind": "observe", "ts": time.time(), "name": name,
               "value": _jsonable(value)}
        if labels:
            rec["labels"] = labels
        self._emit(rec)

    def event(self, name: str, **attrs):
        """A structured one-off event (a resume, a roofline record, ...)."""
        self._emit({"kind": "event", "ts": time.time(), "name": name,
                    "attrs": {k: _jsonable(v) for k, v in attrs.items()}})

    def span(self, name: str, **attrs):
        """Time a ``with`` block; emits a span record on exit."""
        return _Span(self, name, {k: _jsonable(v) for k, v in attrs.items()})

    def span_end(self, name: str, wall_start: float, dur_s: float,
                 attrs: Optional[dict] = None):
        """Record an already-timed interval (for callers that cannot use
        the context-manager form, e.g. async completion callbacks)."""
        rec = {"kind": "span", "ts": wall_start, "name": name,
               "dur_s": float(dur_s), "tid": threading.get_ident() % 100000}
        if attrs:
            rec["attrs"] = {k: _jsonable(v) for k, v in attrs.items()}
        self._emit(rec)

    # -- lifecycle -----------------------------------------------------------
    def flush(self):
        with self._lock:
            if self._fh is not None:
                self._fh.flush()

    def close(self):
        with self._lock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None
