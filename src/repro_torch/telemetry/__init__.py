"""Runtime telemetry for the stencil engine (metrics, spans, roofline gap).

Off by default and a true no-op when off: every instrumentation site in
the engine calls through the module-level singleton returned by
:func:`get`, which is the shared :data:`~repro_torch.telemetry.collector.
NULL` object unless telemetry was enabled. Enabling, as in the reference
package (the same environment variables switch on both):

* environment: ``REPRO_TELEMETRY=1`` (JSONL lands under
  ``$REPRO_TELEMETRY_DIR`` or ``./telemetry/``) or
  ``REPRO_TELEMETRY=/path/run.jsonl`` (explicit log path);
* code: ``telemetry.configure(path=...)``, or per call through the
  ``telemetry=`` argument of ``solve_until`` (a ``Collector``, ``True``,
  ``False``, or ``None`` = inherit the global singleton).

Metrics derived from device values are read only at host syncs that
already exist (the solve's chunk boundaries and its final result), so a
solve launches the same kernels and syncs as often with telemetry on or
off.
"""
from __future__ import annotations

import atexit
import os
import sys
from typing import Optional, Union

from .collector import NULL, Collector, NullCollector, SCHEMA_VERSION

__all__ = [
    "Collector", "NullCollector", "NULL", "SCHEMA_VERSION",
    "get", "enabled", "configure", "configure_rank", "resolve", "reset",
    "count", "gauge", "observe", "event", "span",
]

_ACTIVE: Union[Collector, NullCollector, None] = None   # None = env not read yet


def _truthy(val: str) -> bool:
    return val.strip().lower() not in ("", "0", "false", "off", "no")


def _from_env() -> Union[Collector, NullCollector]:
    val = os.environ.get("REPRO_TELEMETRY", "")
    if not _truthy(val):
        return NULL
    if "/" in val or val.endswith(".jsonl"):
        path = val
    else:
        d = os.environ.get("REPRO_TELEMETRY_DIR", "telemetry")
        path = os.path.join(d, f"run_{os.getpid()}.jsonl")
    col = Collector(path, meta=_run_meta())
    atexit.register(col.close)
    return col


def _run_meta() -> dict:
    import torch

    return {"argv": sys.argv[:4],
            "backend": "cuda" if torch.cuda.is_available() else "cpu"}


def get() -> Union[Collector, NullCollector]:
    """The process-wide collector (the no-op singleton when disabled)."""
    global _ACTIVE
    if _ACTIVE is None:
        _ACTIVE = _from_env()
    return _ACTIVE


def enabled() -> bool:
    return get().enabled


def configure(path: Optional[str] = None, *, enabled: bool = True,
              meta: Optional[dict] = None,
              rank: Optional[int] = None) -> Union[Collector, NullCollector]:
    """Install (or disable) the global collector programmatically,
    overriding the environment. Returns the new active collector."""
    global _ACTIVE
    if _ACTIVE is not None and _ACTIVE.enabled:
        _ACTIVE.close()
    if not enabled:
        _ACTIVE = NULL
    else:
        _ACTIVE = Collector(path, meta={**_run_meta(), **(meta or {})}, rank=rank)
    return _ACTIVE


def configure_rank(rank: int,
                   path: Optional[str] = None) -> Union[Collector, NullCollector]:
    """Per-rank stream for multi-process runs: when telemetry is enabled
    through the environment (or an explicit ``path`` is given), re-point the
    collector at ``rank_<rank>.jsonl`` beside the env-configured sink, with
    every record rank-stamped: the layout ``telemetry.report --merge
    'rank_*.jsonl'`` interleaves. A no-op returning :data:`NULL` when
    telemetry is off (workers can call it unconditionally)."""
    if path is None:
        val = os.environ.get("REPRO_TELEMETRY", "")
        if not _truthy(val):
            return NULL
        if "/" in val or val.endswith(".jsonl"):
            d = os.path.dirname(val) or "."
        else:
            d = os.environ.get("REPRO_TELEMETRY_DIR", "telemetry")
        path = os.path.join(d, f"rank_{rank}.jsonl")
    return configure(path, meta={"rank": rank}, rank=rank)


def reset():
    """Forget any configured or env-resolved collector (tests)."""
    global _ACTIVE
    if _ACTIVE is not None and _ACTIVE.enabled:
        _ACTIVE.close()
    _ACTIVE = None


def resolve(telemetry) -> Union[Collector, NullCollector]:
    """Map a ``telemetry=`` argument to a collector: ``None`` inherits the
    global singleton, ``False`` forces the no-op, ``True`` forces an
    enabled collector (the global one if already enabled, else a fresh
    in-memory one), and a ``Collector`` is used as it is."""
    if telemetry is None:
        return get()
    if telemetry is False:
        return NULL
    if telemetry is True:
        g = get()
        return g if g.enabled else configure(None)
    return telemetry


def count(name, value=1, **labels):
    get().count(name, value, **labels)


def gauge(name, value, **labels):
    get().gauge(name, value, **labels)


def observe(name, value, **labels):
    get().observe(name, value, **labels)


def event(name, **attrs):
    get().event(name, **attrs)


def span(name, **attrs):
    return get().span(name, **attrs)
