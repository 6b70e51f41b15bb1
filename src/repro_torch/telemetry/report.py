"""``python -m repro_torch.telemetry.report RUN.jsonl`` — render a run's event
log into per-phase summary tables and (optionally) the Perfetto trace.

Multi-process runs write one rank-stamped stream per process
(``rank_0.jsonl``, ``rank_1.jsonl``, ... — see
``telemetry.configure_rank``); ``--merge 'rank_*.jsonl'`` interleaves
them by timestamp into one timeline and adds a per-rank phase table, so
a straggling rank shows up as ITS span rows, not an averaged blur.

Offline companion of the live exporters: everything here is a pure
function over the JSONL records, so a log of either package renders the
same tables.
"""
from __future__ import annotations

import argparse
import glob as _glob
import sys

import numpy as np

from . import export, schema

__all__ = ["phase_summary", "counter_totals", "last_gauges",
           "error_trajectory", "format_table", "merge_records",
           "per_rank_phase_summary", "main"]


def phase_summary(records) -> list[dict]:
    """Aggregate span records by name: count, total/mean/p50/p90/max."""
    by_name: dict[str, list[float]] = {}
    for r in records:
        if r.get("kind") == "span":
            by_name.setdefault(r["name"], []).append(float(r["dur_s"]))
    rows = []
    for name in sorted(by_name):
        d = by_name[name]
        rows.append({"phase": name, "count": len(d),
                     "total_s": float(sum(d)),
                     "mean_s": float(np.mean(d)),
                     "p50_s": float(np.percentile(d, 50)),
                     "p90_s": float(np.percentile(d, 90)),
                     "max_s": float(max(d))})
    rows.sort(key=lambda r: -r["total_s"])
    return rows


def counter_totals(records) -> list[dict]:
    totals: dict[tuple, float] = {}
    for r in records:
        if r.get("kind") == "counter":
            key = (r["name"], tuple(sorted((r.get("labels") or {}).items())))
            totals[key] = totals.get(key, 0.0) + float(r["value"])
    return [{"counter": name, "labels": dict(labels), "total": total}
            for (name, labels), total in sorted(totals.items())]


def last_gauges(records) -> list[dict]:
    last: dict[tuple, float] = {}
    for r in records:
        if r.get("kind") == "gauge":
            key = (r["name"], tuple(sorted((r.get("labels") or {}).items())))
            last[key] = float(r["value"])
    return [{"gauge": name, "labels": dict(labels), "value": value}
            for (name, labels), value in sorted(last.items())]


def error_trajectory(records) -> list[dict]:
    """(iters, err, per_step_s) from the chunk-boundary harvest events."""
    out = []
    for r in records:
        if r.get("kind") == "event" and r["name"] == "solve.trajectory":
            a = r.get("attrs", {})
            out.append({"iters": a.get("iters"), "err": a.get("err"),
                        "per_step_s": a.get("per_step_s")})
    return out


def _stream_rank(path: str, records) -> object:
    """The rank a stream belongs to: record stamps win, then the meta
    head, then a ``rank_<i>`` filename; '?' when untagged."""
    for r in records:
        if "rank" in r:
            return r["rank"]
    import re
    m = re.search(r"rank_(\d+)", path)
    return int(m.group(1)) if m else "?"


def merge_records(paths: list[str]) -> list[dict]:
    """Interleave several per-rank JSONL streams into one timestamp-
    ordered record list. Every record carries a ``rank`` key afterwards
    (stamped from the stream when its own records were not). The sort is
    stable, so same-timestamp records keep per-stream order."""
    merged: list[dict] = []
    for path in paths:
        records = schema.load_records(path)
        rank = _stream_rank(path, records)
        for r in records:
            if "rank" not in r:
                r = dict(r, rank=rank)
            merged.append(r)
    merged.sort(key=lambda r: float(r.get("ts", 0.0)))
    return merged


def per_rank_phase_summary(records) -> list[dict]:
    """Span aggregates split by rank — rows ordered (phase, rank) so one
    rank's outlier durations sit next to its peers'."""
    by_key: dict[tuple, list[float]] = {}
    for r in records:
        if r.get("kind") == "span":
            by_key.setdefault((r["name"], r.get("rank", "?")),
                              []).append(float(r["dur_s"]))
    rows = []
    for (name, rank) in sorted(by_key, key=str):
        d = by_key[(name, rank)]
        rows.append({"phase": name, "rank": rank, "count": len(d),
                     "total_s": float(sum(d)),
                     "mean_s": float(np.mean(d)),
                     "p90_s": float(np.percentile(d, 90)),
                     "max_s": float(max(d))})
    return rows


def format_table(rows: list[dict], cols: list[str],
                 title: str | None = None) -> str:
    """Plain fixed-width text table (markdown-pipe style)."""
    if not rows:
        return ""

    def fmt(v):
        if isinstance(v, float):
            return f"{v:.4g}"
        if isinstance(v, dict):
            return ",".join(f"{k}={x}" for k, x in v.items()) or "-"
        return str(v)

    cells = [[fmt(r.get(c, "")) for c in cols] for r in rows]
    widths = [max(len(c), *(len(row[i]) for row in cells))
              for i, c in enumerate(cols)]
    lines = []
    if title:
        lines.append(f"## {title}")
    lines.append(" | ".join(c.ljust(w) for c, w in zip(cols, widths)))
    lines.append("-|-".join("-" * w for w in widths))
    for row in cells:
        lines.append(" | ".join(v.ljust(w) for v, w in zip(row, widths)))
    return "\n".join(lines)


def render(records, out=None, per_rank: bool = False):
    out = out if out is not None else sys.stdout
    meta = next((r for r in records if r.get("kind") == "meta"), {})
    ranks = sorted({r["rank"] for r in records if "rank" in r}, key=str)
    head = (f"# telemetry report (schema {meta.get('schema', '?')}, "
            f"pid {meta.get('pid', '?')}, backend {meta.get('backend', '?')}")
    if per_rank and ranks:
        head += f", ranks {ranks}"
    print(head + ")", file=out)
    tables = [
        ("Per-phase spans", phase_summary(records),
         ["phase", "count", "total_s", "mean_s", "p50_s", "p90_s", "max_s"]),
    ]
    if per_rank:
        tables.append(
            ("Per-rank phases", per_rank_phase_summary(records),
             ["phase", "rank", "count", "total_s", "mean_s", "p90_s",
              "max_s"]))
    tables += [
        ("Counters", counter_totals(records), ["counter", "labels", "total"]),
        ("Gauges (last value)", last_gauges(records),
         ["gauge", "labels", "value"]),
        ("Error trajectory", error_trajectory(records),
         ["iters", "err", "per_step_s"]),
    ]
    for title, rows, cols in tables:
        t = format_table(rows, cols, title)
        if t:
            print("\n" + t, file=out)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.telemetry.report",
        description="Summarize a telemetry JSONL run log.")
    p.add_argument("log", nargs="*", help="telemetry JSONL file(s)")
    p.add_argument("--merge", metavar="GLOB", action="append", default=[],
                   help="interleave per-rank streams matching this glob "
                        "(e.g. 'rank_*.jsonl') by timestamp; adds a "
                        "per-rank phase table")
    p.add_argument("--trace", metavar="OUT.json", default=None,
                   help="also write the Chrome/Perfetto trace here")
    p.add_argument("--validate", action="store_true",
                   help="schema-validate the log first (exit 1 on drift)")
    args = p.parse_args(argv)
    paths = list(args.log)
    for pattern in args.merge:
        hits = sorted(_glob.glob(pattern))
        if not hits:
            print(f"# no files match {pattern!r}", file=sys.stderr)
        paths += hits
    if not paths:
        p.error("pass a JSONL file or --merge GLOB")
    if args.validate:
        for path in paths:
            schema.validate_file(path)
    merged = bool(args.merge) or len(paths) > 1
    records = merge_records(paths) if merged else schema.load_records(paths[0])
    render(records, per_rank=merged)
    if args.trace:
        n = export.write_chrome_trace(records, args.trace)
        print(f"\nwrote {n} trace events -> {args.trace}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
