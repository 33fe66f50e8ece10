"""Trace spans for the data plane (docs/TELEMETRY.md).

A ``Tracer`` emits NESTED spans with monotonic timestamps: each thread
keeps its own open-span stack, so spans opened on one mailbox thread
nest under that thread's enclosing span and the resulting forest is
well-nested per thread (the invariant the property suite checks).
Finished spans land in a bounded deque (oldest evicted, eviction
counted) and are exported as a Chrome-trace timeline or a canonical
(timestamp-stripped) tree for golden tests — see ``repro.telemetry
.export``.

Attribution convention: every span carries the actor/source/step labels
relevant at its layer (``actor.call`` -> actor+method, ``loader.*`` ->
source, ``planner.*``/``constructor.*`` -> step/bucket), and chaos-
injected faults stamp a ``fault=<kind>`` attribute so soak tests can
assert every injected fault was OBSERVED, not merely scheduled.
"""
from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from typing import Optional


class Span:
    """One finished or in-flight span.  Mutate attrs via ``set_attr``."""

    __slots__ = ("span_id", "parent_id", "name", "attrs", "thread",
                 "start", "end")

    def __init__(self, span_id: int, parent_id: Optional[int], name: str,
                 attrs: dict, thread: str, start: float):
        self.span_id = span_id
        self.parent_id = parent_id
        self.name = name
        self.attrs = attrs
        self.thread = thread
        self.start = start
        self.end: Optional[float] = None

    def set_attr(self, key: str, value) -> None:
        self.attrs[key] = value

    def stamp_fault(self, kind: str) -> None:
        """Mark this span as carrying an injected fault."""
        self.attrs["fault"] = kind

    @property
    def duration(self) -> float:
        return (self.end - self.start) if self.end is not None else 0.0

    def as_dict(self) -> dict:
        return {"span_id": self.span_id, "parent_id": self.parent_id,
                "name": self.name, "attrs": dict(self.attrs),
                "thread": self.thread, "start": self.start,
                "end": self.end}

    def __repr__(self) -> str:
        return f"Span({self.name!r}, id={self.span_id}, " \
               f"parent={self.parent_id}, attrs={self.attrs})"


class _NullSpan:
    """Shared no-op stand-in when telemetry is disabled.  Works both as a
    context manager and as the span it would yield."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def set_attr(self, key: str, value) -> None:
        pass

    def stamp_fault(self, kind: str) -> None:
        pass


NULL_SPAN = _NullSpan()


class _SpanContext:
    __slots__ = ("_tracer", "_name", "_attrs", "_span")

    def __init__(self, tracer: "Tracer", name: str, attrs: dict):
        self._tracer = tracer
        self._name = name
        self._attrs = attrs
        self._span: Optional[Span] = None

    def __enter__(self) -> Span:
        self._span = self._tracer._open(self._name, self._attrs)
        return self._span

    def __exit__(self, exc_type, exc, tb) -> bool:
        self._tracer._close(self._span, exc_type)
        return False


class Tracer:
    """Thread-aware span emitter with a bounded finished-span buffer."""

    def __init__(self, max_spans: int = 65536,
                 clock=time.perf_counter):
        self._clock = clock
        self._lock = threading.Lock()
        self._max_spans = max(int(max_spans), 1)
        self._finished: deque = deque()
        self._local = threading.local()
        self._ids = itertools.count(1)
        self.dropped = 0        # finished spans evicted by the bound

    # -- span lifecycle ----------------------------------------------------
    def span(self, name: str, **attrs) -> _SpanContext:
        """Open a span as a context manager:

            with tracer.span("loader.refill", source="coyo_000") as sp:
                sp.set_attr("records", n)
        """
        return _SpanContext(self, name, attrs)

    def current(self) -> Optional[Span]:
        stack = getattr(self._local, "stack", None)
        return stack[-1] if stack else None

    def _open(self, name: str, attrs: dict) -> Span:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        parent = stack[-1].span_id if stack else None
        span = Span(next(self._ids), parent, name, attrs,
                    threading.current_thread().name, self._clock())
        stack.append(span)
        return span

    def _close(self, span: Optional[Span], exc_type) -> None:
        if span is None:
            return
        span.end = self._clock()
        if exc_type is not None:
            span.attrs.setdefault("error", exc_type.__name__)
        stack = getattr(self._local, "stack", None)
        if stack and stack[-1] is span:
            stack.pop()
        elif stack and span in stack:    # defensive: out-of-order close
            stack.remove(span)
        with self._lock:
            self._finished.append(span)
            while len(self._finished) > self._max_spans:
                self._finished.popleft()
                self.dropped += 1

    # -- export ------------------------------------------------------------
    def finished(self) -> list[Span]:
        """Finished spans in close order (children before parents)."""
        with self._lock:
            return list(self._finished)

    def find(self, name: Optional[str] = None, **attrs) -> list[Span]:
        """Finished spans matching a name and/or attr subset."""
        out = []
        for s in self.finished():
            if name is not None and s.name != name:
                continue
            if all(s.attrs.get(k) == v for k, v in attrs.items()):
                out.append(s)
        return out

    def clear(self) -> None:
        with self._lock:
            self._finished.clear()
            self.dropped = 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._finished)
