"""Metric primitives for the unified telemetry plane (docs/TELEMETRY.md).

Three instrument kinds behind one thread-safe ``MetricsRegistry``:

  * Counter   — monotone float accumulator.  ``merge`` is associative
                (plain addition), so per-shard registries can be folded
                in any order.
  * Gauge     — last-write-wins sample of a level (queue depth, breaker
                state, token imbalance).
  * Histogram — streaming distribution with a BOUNDED reservoir
                (Algorithm R with a seeded RNG, so two same-seed runs
                keep identical reservoirs).  Quantiles are nearest-rank
                over the sorted reservoir, hence monotone in q — the
                invariant the property suite asserts.

Zero hard dependencies; safe to import from every layer (core, chaos,
analysis) without cycles.
"""
from __future__ import annotations

import math
import random
import threading
from typing import Iterable, Optional

DEFAULT_RESERVOIR = 512


def label_key(labels: dict) -> tuple:
    """Canonical hashable identity for a label set (values stringified)."""
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def render_key(name: str, key: tuple) -> str:
    """Prometheus-style series name: ``name{a="x",b="y"}``."""
    if not key:
        return name
    inner = ",".join(f'{k}="{v}"' for k, v in key)
    return f"{name}{{{inner}}}"


class Counter:
    """Monotonically increasing accumulator (thread-safe)."""

    __slots__ = ("_lock", "_value")

    def __init__(self, value: float = 0.0):
        self._lock = threading.Lock()
        self._value = float(value)

    def inc(self, value: float = 1.0) -> None:
        if value < 0:
            raise ValueError(f"counter increment must be >= 0, got {value}")
        with self._lock:
            self._value += value

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    def merge(self, other: "Counter") -> "Counter":
        """Fold two counters into a new one.  Addition is associative and
        commutative, so any merge tree yields the same total."""
        return Counter(self.value + other.value)


class Gauge:
    """Last-write-wins level sample (thread-safe)."""

    __slots__ = ("_lock", "_value")

    def __init__(self, value: float = 0.0):
        self._lock = threading.Lock()
        self._value = float(value)

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)

    def add(self, delta: float) -> None:
        with self._lock:
            self._value += float(delta)

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Histogram:
    """Streaming distribution with a bounded reservoir (thread-safe).

    Keeps exact count/sum/min/max plus a ``capacity``-bounded uniform
    sample of observations (Algorithm R, seeded for reproducibility).
    Quantiles are nearest-rank over the sorted reservoir: the index is a
    nondecreasing function of q, so quantiles are monotone by
    construction.
    """

    __slots__ = ("_lock", "capacity", "_reservoir", "_count", "_sum",
                 "_min", "_max", "_rng")

    def __init__(self, capacity: int = DEFAULT_RESERVOIR, seed: int = 0):
        self._lock = threading.Lock()
        self.capacity = max(int(capacity), 1)
        self._reservoir: list[float] = []
        self._count = 0
        self._sum = 0.0
        self._min = math.inf
        self._max = -math.inf
        self._rng = random.Random(seed)

    def observe(self, value: float) -> None:
        v = float(value)
        with self._lock:
            self._count += 1
            self._sum += v
            self._min = min(self._min, v)
            self._max = max(self._max, v)
            if len(self._reservoir) < self.capacity:
                self._reservoir.append(v)
            else:
                j = self._rng.randrange(self._count)
                if j < self.capacity:
                    self._reservoir[j] = v

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    def quantile(self, q: float) -> float:
        with self._lock:
            data = sorted(self._reservoir)
        if not data:
            return math.nan
        q = min(max(float(q), 0.0), 1.0)
        idx = min(len(data) - 1, max(0, math.ceil(q * len(data)) - 1))
        return data[idx]

    def quantiles(self, qs: Iterable[float]) -> list[float]:
        with self._lock:
            data = sorted(self._reservoir)
        out = []
        for q in qs:
            if not data:
                out.append(math.nan)
                continue
            q = min(max(float(q), 0.0), 1.0)
            idx = min(len(data) - 1, max(0, math.ceil(q * len(data)) - 1))
            out.append(data[idx])
        return out

    def snapshot(self) -> dict:
        with self._lock:
            data = sorted(self._reservoir)
            count, total = self._count, self._sum
            lo = self._min if count else math.nan
            hi = self._max if count else math.nan

        def _q(q: float) -> float:
            if not data:
                return math.nan
            return data[min(len(data) - 1, max(0, math.ceil(q * len(data)) - 1))]

        return {"count": count, "sum": total, "min": lo, "max": hi,
                "p50": _q(0.5), "p90": _q(0.9), "p99": _q(0.99)}


class MetricsRegistry:
    """Get-or-create home for every metric series (thread-safe).

    Series identity is ``(name, sorted label items)``; label values are
    stringified so ``rank=0`` and ``rank="0"`` are the same series.
    """

    def __init__(self, seed: int = 0,
                 histogram_capacity: int = DEFAULT_RESERVOIR):
        self._lock = threading.Lock()
        self.seed = seed
        self.histogram_capacity = histogram_capacity
        self._counters: dict[tuple, Counter] = {}
        self._gauges: dict[tuple, Gauge] = {}
        self._histograms: dict[tuple, Histogram] = {}

    # -- get-or-create -----------------------------------------------------
    def counter(self, name: str, **labels) -> Counter:
        k = (name, label_key(labels))
        with self._lock:
            c = self._counters.get(k)
            if c is None:
                c = self._counters[k] = Counter()
            return c

    def gauge(self, name: str, **labels) -> Gauge:
        k = (name, label_key(labels))
        with self._lock:
            g = self._gauges.get(k)
            if g is None:
                g = self._gauges[k] = Gauge()
            return g

    def histogram(self, name: str, **labels) -> Histogram:
        k = (name, label_key(labels))
        with self._lock:
            h = self._histograms.get(k)
            if h is None:
                h = self._histograms[k] = Histogram(
                    self.histogram_capacity,
                    seed=hash((self.seed,) + k) & 0x7FFFFFFF)
            return h

    # -- convenience writers ----------------------------------------------
    def inc(self, name: str, value: float = 1.0, **labels) -> None:
        self.counter(name, **labels).inc(value)

    def set_gauge(self, name: str, value: float, **labels) -> None:
        self.gauge(name, **labels).set(value)

    def observe(self, name: str, value: float, **labels) -> None:
        self.histogram(name, **labels).observe(value)

    # -- readers -----------------------------------------------------------
    def counter_value(self, name: str, **labels) -> float:
        with self._lock:
            c = self._counters.get((name, label_key(labels)))
        return c.value if c is not None else 0.0

    def counter_total(self, name: str) -> float:
        """Sum of one counter name across all label sets."""
        with self._lock:
            items = [c for (n, _), c in self._counters.items() if n == name]
        return sum(c.value for c in items)

    def gauge_value(self, name: str, default: float = math.nan,
                    **labels) -> float:
        with self._lock:
            g = self._gauges.get((name, label_key(labels)))
        return g.value if g is not None else default

    def series(self) -> dict:
        """Raw (kind -> {(name, labelkey) -> metric}) view; internal."""
        with self._lock:
            return {"counters": dict(self._counters),
                    "gauges": dict(self._gauges),
                    "histograms": dict(self._histograms)}

    def snapshot(self) -> dict:
        """JSON-able dump: rendered series name -> value(s)."""
        s = self.series()
        return {
            "counters": {render_key(n, k): c.value
                         for (n, k), c in sorted(s["counters"].items())},
            "gauges": {render_key(n, k): g.value
                       for (n, k), g in sorted(s["gauges"].items())},
            "histograms": {render_key(n, k): h.snapshot()
                           for (n, k), h in sorted(s["histograms"].items())},
        }

    def merge(self, other: "MetricsRegistry") -> "MetricsRegistry":
        """Fold another registry into a NEW one: counters add, gauges take
        the other side's sample when present (latest wins), histogram
        moments add with reservoirs concatenated up to capacity."""
        out = MetricsRegistry(seed=self.seed,
                              histogram_capacity=self.histogram_capacity)
        mine, theirs = self.series(), other.series()
        for (n, k), c in mine["counters"].items():
            out._counters[(n, k)] = Counter(c.value)
        for (n, k), c in theirs["counters"].items():
            prev = out._counters.get((n, k))
            out._counters[(n, k)] = c.merge(prev) if prev else Counter(c.value)
        for src in (mine["gauges"], theirs["gauges"]):
            for (n, k), g in src.items():
                out._gauges[(n, k)] = Gauge(g.value)
        for src in (mine["histograms"], theirs["histograms"]):
            for (n, k), h in src.items():
                dst = out._histograms.get((n, k))
                if dst is None:
                    dst = out._histograms[(n, k)] = Histogram(
                        self.histogram_capacity)
                with h._lock:
                    res, cnt, tot = list(h._reservoir), h._count, h._sum
                    lo, hi = h._min, h._max
                dst._count += cnt
                dst._sum += tot
                dst._min = min(dst._min, lo)
                dst._max = max(dst._max, hi)
                room = dst.capacity - len(dst._reservoir)
                dst._reservoir.extend(res[:room])
        return out
