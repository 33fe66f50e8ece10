"""Retry / breaker / quarantine policies used by the chaos harness.

The canonical implementations live in ``repro.core.resilience`` (core
must not depend on chaos); this module is the chaos-facing surface plus
ready-made policy presets for fault drills.
"""
from __future__ import annotations

from repro_torch.core.resilience import (  # noqa: F401
    CircuitBreaker, CorruptSampleError, DeadLetterQueue, RetryPolicy,
    TransientIOError, validate_positive_policy,
)


def aggressive_retry(seed: int = 0) -> RetryPolicy:
    """Fast, many-attempt policy for soak tests (sub-ms base delay)."""
    return RetryPolicy(max_attempts=5, base_delay_s=0.005,
                       max_delay_s=0.1, seed=seed)


def patient_retry(seed: int = 0) -> RetryPolicy:
    """Production-shaped policy: fewer attempts, longer backoff."""
    return RetryPolicy(max_attempts=3, base_delay_s=0.1,
                       max_delay_s=2.0, seed=seed)
