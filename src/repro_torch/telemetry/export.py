"""Export surfaces for the telemetry plane (docs/TELEMETRY.md).

  * ``render_prometheus`` — text exposition of a MetricsRegistry
    (counters/gauges as-is, histograms as summaries with quantiles).
  * ``chrome_trace`` / ``write_chrome_trace`` — span timeline in the
    Chrome ``chrome://tracing`` / Perfetto JSON format.
  * ``canonical_spans`` — deterministic, timestamp-stripped span TREE
    for golden-trace regression tests: ids, timestamps, durations and
    thread names are dropped; attrs survive (minus an optional strip
    set) so the tree captures *what happened in what order under what*,
    not *when*.
"""
from __future__ import annotations

import json
import math
from typing import Iterable, Optional

from repro_torch.telemetry.metrics import MetricsRegistry, render_key
from repro_torch.telemetry.tracing import Span, Tracer


def _sanitize(value):
    if isinstance(value, bool):
        return str(value)
    if isinstance(value, (int, float, str)) or value is None:
        return value
    return str(value)


# -- Prometheus text exposition -------------------------------------------
def render_prometheus(registry: MetricsRegistry,
                      namespace: str = "repro") -> str:
    """Prometheus-style text dump.  Histograms are rendered as summaries
    (``{quantile="..."}`` series plus ``_count`` / ``_sum``)."""
    s = registry.series()
    lines: list[str] = []
    seen_types: set[str] = set()

    def _type_line(name: str, kind: str):
        if name not in seen_types:
            seen_types.add(name)
            lines.append(f"# TYPE {name} {kind}")

    for (name, key), c in sorted(s["counters"].items()):
        full = f"{namespace}_{name}"
        _type_line(full, "counter")
        lines.append(f"{render_key(full, key)} {c.value:.10g}")
    for (name, key), g in sorted(s["gauges"].items()):
        full = f"{namespace}_{name}"
        _type_line(full, "gauge")
        lines.append(f"{render_key(full, key)} {g.value:.10g}")
    for (name, key), h in sorted(s["histograms"].items()):
        full = f"{namespace}_{name}"
        _type_line(full, "summary")
        snap = h.snapshot()
        for q, label in ((snap["p50"], "0.5"), (snap["p90"], "0.9"),
                         (snap["p99"], "0.99")):
            if not math.isnan(q):
                qkey = key + (("quantile", label),)
                lines.append(f"{render_key(full, tuple(sorted(qkey)))} "
                             f"{q:.10g}")
        lines.append(f"{render_key(full + '_count', key)} {snap['count']}")
        lines.append(f"{render_key(full + '_sum', key)} "
                     f"{snap['sum']:.10g}")
    return "\n".join(lines) + ("\n" if lines else "")


def parse_prometheus(text: str) -> dict[str, float]:
    """Minimal parser for the exposition above (tests round-trip on it)."""
    out: dict[str, float] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        series, value = line.rsplit(" ", 1)
        out[series] = float(value)
    return out


# -- Chrome trace ----------------------------------------------------------
def _spans_of(source) -> list[Span]:
    if isinstance(source, Tracer):
        return source.finished()
    return list(source)


def chrome_trace(source) -> dict:
    """Complete-event ("ph": "X") Chrome trace; times in microseconds."""
    spans = _spans_of(source)
    tid_of: dict[str, int] = {}
    events = []
    for s in sorted(spans, key=lambda s: (s.start, s.span_id)):
        tid = tid_of.setdefault(s.thread, len(tid_of) + 1)
        events.append({
            "name": s.name, "cat": "repro", "ph": "X",
            "ts": s.start * 1e6, "dur": s.duration * 1e6,
            "pid": 1, "tid": tid,
            "args": {k: _sanitize(v) for k, v in s.attrs.items()},
        })
    meta = [{"name": "thread_name", "ph": "M", "pid": 1, "tid": tid,
             "args": {"name": thread}}
            for thread, tid in sorted(tid_of.items(), key=lambda kv: kv[1])]
    return {"traceEvents": meta + events, "displayTimeUnit": "ms"}


def write_chrome_trace(path: str, source) -> str:
    with open(path, "w", encoding="utf-8") as f:
        json.dump(chrome_trace(source), f)
    return path


# -- canonical span tree (golden tests) ------------------------------------
def canonical_spans(source, strip_attrs: Iterable[str] = ()) -> list[dict]:
    """Timestamp-stripped span forest, children in start order.

    A span whose parent never finished (still open at export) is
    promoted to a root — the tree must be buildable from whatever the
    bounded buffer holds.
    """
    spans = _spans_of(source)
    strip = set(strip_attrs) | {"error"}
    by_id = {s.span_id: s for s in spans}
    children: dict[Optional[int], list[Span]] = {}
    for s in spans:
        parent = s.parent_id if s.parent_id in by_id else None
        children.setdefault(parent, []).append(s)

    def _node(s: Span) -> dict:
        node = {"name": s.name,
                "attrs": {k: _sanitize(v)
                          for k, v in sorted(s.attrs.items())
                          if k not in strip}}
        kids = sorted(children.get(s.span_id, []),
                      key=lambda c: (c.start, c.span_id))
        if kids:
            node["children"] = [_node(c) for c in kids]
        return node

    roots = sorted(children.get(None, []), key=lambda s: (s.start, s.span_id))
    return [_node(s) for s in roots]
