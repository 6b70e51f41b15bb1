"""JSONL event-log schema: documented record shapes and a strict validator.

The port's own copy of the reference's schema: the same
``SCHEMA_VERSION`` and the same record kinds, so a run log of either
package validates under the other's validator.

Every line of a telemetry run log is one JSON object with a ``kind`` and
a float ``ts`` (unix seconds). Per kind:

``meta``     ``{kind, ts, schema, pid, ...}``: first line of every log;
             ``schema`` is the integer :data:`~repro_torch.telemetry.
             collector.SCHEMA_VERSION`.
``counter``  ``{kind, ts, name, value, labels?}``: a monotonic increment.
``gauge``    ``{kind, ts, name, value, labels?}``: point-in-time value.
``observe``  ``{kind, ts, name, value, labels?}``: histogram sample.
``span``     ``{kind, ts, name, dur_s, tid?, attrs?}``: a timed interval;
             ``ts`` is the wall-clock start, ``dur_s >= 0`` the duration.
``event``    ``{kind, ts, name, attrs}``: structured one-off record.

``labels`` values must be JSON scalars; ``attrs`` any JSON value.
Multi-process streams additionally stamp every record with an integer
``rank`` (see ``telemetry.configure_rank``); validators treat it like any
other extra key. ``python -m repro_torch.telemetry.schema RUN.jsonl``
validates a log from the command line.
"""
from __future__ import annotations

import json
import sys
from typing import Mapping

from .collector import SCHEMA_VERSION

KINDS = ("meta", "counter", "gauge", "observe", "span", "event")
_SCALAR = (bool, int, float, str, type(None))

__all__ = ["SCHEMA_VERSION", "KINDS", "SchemaError", "validate_record", "validate_file",
           "load_records"]


class SchemaError(ValueError):
    pass


def _num(v) -> bool:
    return isinstance(v, (int, float)) and not isinstance(v, bool)


def validate_record(rec, lineno: int | None = None) -> str:
    """Validate one decoded record; returns its kind or raises
    :class:`SchemaError` naming the offending line and field."""
    where = f"line {lineno}: " if lineno is not None else ""
    if not isinstance(rec, Mapping):
        raise SchemaError(f"{where}record is not a JSON object")
    kind = rec.get("kind")
    if kind not in KINDS:
        raise SchemaError(f"{where}unknown kind {kind!r} (expected one of {KINDS})")
    if not _num(rec.get("ts")):
        raise SchemaError(f"{where}{kind}: 'ts' must be a number")
    if kind == "meta":
        if not isinstance(rec.get("schema"), int):
            raise SchemaError(f"{where}meta: integer 'schema' required")
        return kind
    if not isinstance(rec.get("name"), str) or not rec["name"]:
        raise SchemaError(f"{where}{kind}: non-empty string 'name' required")
    if kind in ("counter", "gauge", "observe"):
        if not _num(rec.get("value")):
            raise SchemaError(f"{where}{kind} {rec['name']!r}: numeric 'value' required")
        labels = rec.get("labels", {})
        if not isinstance(labels, Mapping) or any(
                not isinstance(v, _SCALAR) for v in labels.values()):
            raise SchemaError(f"{where}{kind} {rec['name']!r}: labels must map to scalars")
    elif kind == "span":
        if not _num(rec.get("dur_s")) or rec["dur_s"] < 0:
            raise SchemaError(f"{where}span {rec['name']!r}: 'dur_s' must be >= 0")
        if not isinstance(rec.get("attrs", {}), Mapping):
            raise SchemaError(f"{where}span {rec['name']!r}: attrs must be an object")
    elif kind == "event":
        if not isinstance(rec.get("attrs", {}), Mapping):
            raise SchemaError(f"{where}event {rec['name']!r}: attrs must be an object")
    return kind


def load_records(path: str) -> list[dict]:
    """Parse a JSONL log (no validation)."""
    out = []
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out


def validate_file(path: str) -> dict[str, int]:
    """Validate every line of a JSONL log; returns per-kind counts."""
    counts: dict[str, int] = {}
    with open(path) as fh:
        for i, line in enumerate(fh, 1):
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError as e:
                raise SchemaError(f"line {i}: invalid JSON ({e})") from None
            kind = validate_record(rec, i)
            counts[kind] = counts.get(kind, 0) + 1
    if counts.get("meta", 0) < 1:
        raise SchemaError("log has no 'meta' header record")
    return counts


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv:
        print("usage: python -m repro_torch.telemetry.schema RUN.jsonl [...]",
              file=sys.stderr)
        return 2
    for path in argv:
        try:
            counts = validate_file(path)
        except (OSError, SchemaError) as e:
            print(f"{path}: INVALID: {e}", file=sys.stderr)
            return 1
        total = sum(counts.values())
        detail = ", ".join(f"{k}={counts[k]}" for k in sorted(counts))
        print(f"{path}: OK ({total} records: {detail})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
