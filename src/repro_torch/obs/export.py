"""Span export: Chrome-trace / Perfetto JSON and the compact text summary;
counterpart of `repro.obs.export`.

The JSON uses the Chrome Trace Event format's complete events (`"ph": "X"`,
microsecond timestamps) — the schema Perfetto's trace viewer and
`chrome://tracing` both load directly. Span kinds map to the `cat` field
(`stage` / `dispatch` / `execute`), so compile-vs-execute attribution
survives into the viewer's query layer, and attributes land in `args`.
"""
from __future__ import annotations

import json
from pathlib import Path

from .trace import Span, Tracer, get_tracer

__all__ = ["to_chrome_trace", "write_chrome_trace", "summary",
           "stage_breakdown", "coverage"]


def to_chrome_trace(tracer: Tracer = None,
                    process_name: str = "repro_torch") -> dict:
    """Chrome Trace Event JSON object for every closed span."""
    tracer = tracer or get_tracer()
    t0 = tracer.t0_ns
    events = [{
        "name": "process_name", "ph": "M", "pid": 1, "tid": 0,
        "args": {"name": process_name},
    }]
    for s in tracer.closed_spans():
        if s.end_ns is None:
            continue
        events.append({
            "name": s.name,
            "cat": s.kind,
            "ph": "X",
            "pid": 1,
            "tid": s.tid % 2**31,
            "ts": (s.start_ns - t0) / 1e3,      # microseconds
            "dur": (s.end_ns - s.start_ns) / 1e3,
            "args": {k: _jsonable(v) for k, v in s.attrs.items()},
        })
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def _jsonable(v):
    try:
        json.dumps(v)
        return v
    except TypeError:
        return repr(v)


def write_chrome_trace(path, tracer: Tracer = None, **kw) -> Path:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(to_chrome_trace(tracer, **kw)) + "\n")
    return path


# ---------------------------------------------------------------------------
# Text summary
# ---------------------------------------------------------------------------


def _self_ns(span: Span, spans: list[Span]) -> int:
    """Span duration minus time covered by its direct children (same thread,
    depth + 1, nested inside the interval)."""
    child = sum(
        c.end_ns - c.start_ns for c in spans
        if (c.tid == span.tid and c.depth == span.depth + 1
            and c.end_ns is not None
            and c.start_ns >= span.start_ns and c.end_ns <= span.end_ns))
    return max(span.end_ns - span.start_ns - child, 0)


def stage_breakdown(tracer: Tracer = None) -> dict:
    """Per-span-name totals: {name: {count, total_ms, self_ms, kind}}.

    `self_ms` excludes nested child spans, so summing it over all names
    tiles the instrumented wall-clock without double counting — the number
    the coverage check of a traced run is computed from.
    """
    tracer = tracer or get_tracer()
    spans = [s for s in tracer.closed_spans() if s.end_ns is not None]
    out: dict[str, dict] = {}
    for s in spans:
        row = out.setdefault(s.name, {"count": 0, "total_ms": 0.0,
                                      "self_ms": 0.0, "kind": s.kind})
        row["count"] += 1
        row["total_ms"] += (s.end_ns - s.start_ns) / 1e6
        row["self_ms"] += _self_ns(s, spans) / 1e6
    for row in out.values():
        row["total_ms"] = round(row["total_ms"], 3)
        row["self_ms"] = round(row["self_ms"], 3)
    return out


def coverage(tracer: Tracer = None) -> float:
    """Fraction of the first-span..last-span wall-clock covered by spans
    (union of top-level intervals per thread)."""
    tracer = tracer or get_tracer()
    spans = [s for s in tracer.closed_spans()
             if s.end_ns is not None and s.depth == 0]
    if not spans:
        return 0.0
    wall = tracer.wall_ns()
    if wall <= 0:
        return 1.0
    ivs = sorted((s.start_ns, s.end_ns) for s in spans)
    covered, cur_lo, cur_hi = 0, ivs[0][0], ivs[0][1]
    for lo, hi in ivs[1:]:
        if lo > cur_hi:
            covered += cur_hi - cur_lo
            cur_lo, cur_hi = lo, hi
        else:
            cur_hi = max(cur_hi, hi)
    covered += cur_hi - cur_lo
    return covered / wall


def summary(tracer: Tracer = None, top: int = 24) -> str:
    """Compact text table, heaviest self-time first."""
    tracer = tracer or get_tracer()
    rows = stage_breakdown(tracer)
    wall_ms = tracer.wall_ns() / 1e6
    lines = [f"trace: {sum(r['count'] for r in rows.values())} spans, "
             f"wall {wall_ms:.1f} ms, coverage {coverage(tracer):.0%}",
             f"{'span':40s} {'kind':9s} {'n':>5s} {'total ms':>10s} "
             f"{'self ms':>10s} {'% wall':>7s}"]
    order = sorted(rows.items(), key=lambda kv: -kv[1]["self_ms"])
    for name, r in order[:top]:
        pct = 100.0 * r["self_ms"] / wall_ms if wall_ms > 0 else 0.0
        lines.append(f"{name[:40]:40s} {r['kind']:9s} {r['count']:5d} "
                     f"{r['total_ms']:10.2f} {r['self_ms']:10.2f} "
                     f"{pct:6.1f}%")
    return "\n".join(lines)
