"""Exporters: Prometheus text exposition and Chrome/Perfetto traces.

The JSONL event log is the source of truth; both exports are pure
projections of it (or of a live :class:`~repro_torch.telemetry.collector
.Collector`'s in-memory state), so they can be regenerated offline by
``python -m repro_torch.telemetry.report`` long after the run.
"""
from __future__ import annotations

import json
import re
from typing import Iterable

import numpy as np

__all__ = ["prometheus_text", "chrome_trace_events", "write_chrome_trace"]

_NAME_RE = re.compile(r"[^a-zA-Z0-9_]")


def _prom_name(name: str) -> str:
    n = _NAME_RE.sub("_", name)
    return n if n.startswith("repro_") else f"repro_{n}"


def _prom_labels(labels) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{_NAME_RE.sub("_", str(k))}="{v}"' for k, v in labels)
    return "{" + inner + "}"


def prometheus_text(collector) -> str:
    """Render a collector's counters/gauges/histogram summaries in the
    Prometheus text exposition format (counters get ``_total``,
    histograms degrade to p50/p90/max summary gauges)."""
    lines: list[str] = []
    for (name, labels), v in sorted(collector.counters.items()):
        pn = _prom_name(name) + "_total"
        lines.append(f"# TYPE {pn} counter")
        lines.append(f"{pn}{_prom_labels(labels)} {v}")
    for (name, labels), v in sorted(collector.gauges.items()):
        pn = _prom_name(name)
        lines.append(f"# TYPE {pn} gauge")
        lines.append(f"{pn}{_prom_labels(labels)} {v}")
    for (name, labels), samples in sorted(collector.hists.items()):
        pn = _prom_name(name)
        lines.append(f"# TYPE {pn} summary")
        for q, val in (("0.5", np.percentile(samples, 50)),
                       ("0.9", np.percentile(samples, 90)),
                       ("1", max(samples))):
            lab = dict(labels)
            lab["quantile"] = q
            lines.append(f"{pn}{_prom_labels(sorted(lab.items()))} {float(val)}")
        lines.append(f"{pn}_count{_prom_labels(labels)} {len(samples)}")
        lines.append(f"{pn}_sum{_prom_labels(labels)} {float(sum(samples))}")
    return "\n".join(lines) + "\n"


def chrome_trace_events(records: Iterable[dict]) -> list[dict]:
    """Project JSONL records onto Chrome ``trace_event`` objects
    (loadable by Perfetto / chrome://tracing): spans become complete
    ``"X"`` slices, counters and gauges become ``"C"`` counter tracks,
    events become instants."""
    out: list[dict] = []
    pid = 0
    counters: dict[str, float] = {}
    for rec in records:
        kind = rec.get("kind")
        ts_us = float(rec.get("ts", 0.0)) * 1e6
        if kind == "meta":
            pid = int(rec.get("pid", 0))
            out.append({"name": "process_name", "ph": "M", "pid": pid,
                        "args": {"name": "repro-telemetry"}})
        elif kind == "span":
            out.append({"name": rec["name"], "cat": "repro", "ph": "X",
                        "ts": ts_us, "dur": float(rec["dur_s"]) * 1e6,
                        "pid": pid, "tid": int(rec.get("tid", 0)),
                        "args": rec.get("attrs", {})})
        elif kind == "counter":
            counters[rec["name"]] = counters.get(rec["name"], 0.0) + rec["value"]
            out.append({"name": rec["name"], "cat": "repro", "ph": "C",
                        "ts": ts_us, "pid": pid,
                        "args": {rec["name"]: counters[rec["name"]]}})
        elif kind in ("gauge", "observe"):
            out.append({"name": rec["name"], "cat": "repro", "ph": "C",
                        "ts": ts_us, "pid": pid,
                        "args": {rec["name"]: rec["value"]}})
        elif kind == "event":
            out.append({"name": rec["name"], "cat": "repro", "ph": "i",
                        "ts": ts_us, "pid": pid, "tid": 0, "s": "g",
                        "args": rec.get("attrs", {})})
    return out


def write_chrome_trace(records: Iterable[dict], path: str) -> int:
    """Write the Perfetto-loadable trace JSON; returns the event count."""
    events = chrome_trace_events(records)
    with open(path, "w") as fh:
        json.dump({"traceEvents": events, "displayTimeUnit": "ms"}, fh)
    return len(events)
