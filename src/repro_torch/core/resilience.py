"""Hardening primitives for the data plane (§6 + docs/FAULT_TOLERANCE.md).

Three building blocks the fault paths share, kept dependency-free so both
``repro.core`` and ``repro.chaos`` can layer on them:

  * RetryPolicy — exponential backoff with DETERMINISTIC jitter (seeded,
    so chaos runs reproduce byte-identical timing decisions), a max
    attempt budget, and retryable-exception classification.
  * CircuitBreaker — per-source storage protection: opens after N
    consecutive read failures, half-open probe after a cooldown, closes
    on probe success.  While open the loader serves from its buffer and
    the Planner re-mixes across healthy sources.
  * DeadLetterQueue — bounded quarantine for corrupted samples with
    source attribution; the loader keeps running instead of dying on a
    bad record.
"""
from __future__ import annotations

import concurrent.futures
import dataclasses
import math
import random
import threading
import time
from collections import Counter, deque
from typing import Callable, Optional


class TransientIOError(IOError):
    """A storage hiccup worth retrying (network blip, throttling, ...)."""


class CorruptSampleError(ValueError):
    """A record that failed integrity validation; quarantine, don't die."""


# concurrent.futures.TimeoutError only aliases the builtin from 3.11 on
RETRYABLE_DEFAULT: tuple = (TimeoutError, concurrent.futures.TimeoutError,
                            TransientIOError)


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Exponential backoff + deterministic jitter + exception classes.

    ``run(fn)`` retries ``fn`` on retryable exceptions up to
    ``max_attempts`` total attempts.  Jitter is derived from
    ``(seed, attempt)`` so two runs with the same policy make identical
    timing decisions — a requirement for the reproducible chaos harness.
    """

    max_attempts: int = 3
    base_delay_s: float = 0.02
    max_delay_s: float = 1.0
    multiplier: float = 2.0
    jitter: float = 0.25          # fraction of the delay that is randomized
    retryable: tuple = RETRYABLE_DEFAULT
    seed: int = 0

    def is_retryable(self, exc: BaseException) -> bool:
        return isinstance(exc, tuple(self.retryable))

    def delay(self, attempt: int) -> float:
        raw = min(self.base_delay_s * self.multiplier ** attempt,
                  self.max_delay_s)
        if self.jitter <= 0:
            return raw
        rng = random.Random(f"{self.seed}:{attempt}")
        return raw * (1.0 - self.jitter * rng.random())

    def run(self, fn: Callable, *args,
            on_retry: Optional[Callable[[int, BaseException], None]] = None,
            **kwargs):
        attempts = max(int(self.max_attempts), 1)
        for attempt in range(attempts):
            try:
                return fn(*args, **kwargs)
            except Exception as e:
                if attempt == attempts - 1 or not self.is_retryable(e):
                    raise
                if on_retry is not None:
                    on_retry(attempt, e)
                time.sleep(self.delay(attempt))
        raise RuntimeError("unreachable")  # pragma: no cover


class CircuitBreaker:
    """Consecutive-failure breaker with half-open probing (thread-safe).

    States: ``closed`` (normal) -> ``open`` after ``failure_threshold``
    consecutive failures -> ``half_open`` after ``cooldown_s`` (exactly one
    probe allowed) -> ``closed`` on probe success / back to ``open`` on
    probe failure.
    """

    CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"

    #: numeric encoding for the ``breaker_state`` telemetry gauge
    STATE_VALUES = {"closed": 0.0, "half_open": 0.5, "open": 1.0}

    def __init__(self, failure_threshold: int = 3, cooldown_s: float = 0.25,
                 clock: Callable[[], float] = time.monotonic):
        self.failure_threshold = max(int(failure_threshold), 1)
        self.cooldown_s = max(float(cooldown_s), 0.0)
        self._clock = clock
        self._lock = threading.Lock()
        self._state = self.CLOSED
        self._consecutive = 0
        self._opened_at = 0.0
        self._n_failures = 0
        self._n_opens = 0
        self._n_probes = 0

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    def allow(self) -> bool:
        """May a read proceed now?  Transitions open->half_open (one
        probe) once the cooldown has elapsed."""
        with self._lock:
            if self._state == self.CLOSED:
                return True
            if self._state == self.OPEN:
                if self._clock() - self._opened_at >= self.cooldown_s:
                    self._state = self.HALF_OPEN
                    self._n_probes += 1
                    return True
                return False
            return False   # half-open: a probe is already in flight

    def record_success(self):
        with self._lock:
            self._state = self.CLOSED
            self._consecutive = 0

    def record_failure(self):
        with self._lock:
            self._n_failures += 1
            self._consecutive += 1
            if self._state == self.HALF_OPEN \
                    or self._consecutive >= self.failure_threshold:
                if self._state != self.OPEN:
                    self._n_opens += 1
                self._state = self.OPEN
                self._opened_at = self._clock()

    def gauge_value(self) -> float:
        """State as a number a Prometheus gauge can carry."""
        return self.STATE_VALUES[self.state]

    def stats(self) -> dict:
        with self._lock:
            return {"state": self._state,
                    "consecutive_failures": self._consecutive,
                    "total_failures": self._n_failures,
                    "opens": self._n_opens, "probes": self._n_probes}


class DeadLetterQueue:
    """Bounded quarantine for corrupted samples (thread-safe).

    Entries carry source attribution and the rejection reason; when the
    queue overflows, oldest entries are evicted but the per-source counts
    keep the full history.
    """

    def __init__(self, capacity: int = 4096):
        self.capacity = max(int(capacity), 1)
        self._lock = threading.Lock()
        self._items: deque = deque(maxlen=self.capacity)
        self._counts: Counter = Counter()
        self._total = 0

    def put(self, sample_id: str, source: str, reason: str,
            record: Optional[dict] = None):
        with self._lock:
            self._items.append({
                "sample_id": sample_id, "source": source, "reason": reason,
                "record": record, "time": time.time()})
            self._counts[source] += 1
            self._total += 1

    def items(self) -> list[dict]:
        with self._lock:
            return [dict(it) for it in self._items]

    def sample_ids(self) -> set[str]:
        with self._lock:
            return {it["sample_id"] for it in self._items}

    def counts_by_source(self) -> dict[str, int]:
        with self._lock:
            return dict(self._counts)

    def stats(self) -> dict:
        """The schema ``resilience_report()``/``telemetry_report()`` embed."""
        with self._lock:
            return {"total": self._total, "held": len(self._items),
                    "by_source": dict(self._counts)}

    @property
    def total(self) -> int:
        with self._lock:
            return self._total

    def __len__(self) -> int:
        with self._lock:
            return len(self._items)


def validate_positive_policy(policy: RetryPolicy) -> bool:
    """Sanity used by config lint (CFG309): a policy that can never retry
    or sleeps absurdly is a misconfiguration, not a policy."""
    return (policy.max_attempts >= 1 and policy.base_delay_s >= 0.0
            and policy.max_delay_s >= policy.base_delay_s
            and policy.multiplier >= 1.0 and 0.0 <= policy.jitter <= 1.0
            and math.isfinite(policy.max_delay_s))
