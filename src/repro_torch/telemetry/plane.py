"""The telemetry plane: one MetricsRegistry + one Tracer per Overlord.

``Telemetry`` is the object the whole data plane shares: the Overlord
creates one, hands it to the ActorRuntime and to every actor it spawns,
and every instrumentation site goes through it.  With ``enabled=False``
all writers are no-ops and ``span()`` returns a shared null context
manager, so the disabled overhead is one attribute check per site (the
<= 5% budget benchmarks/orchestration.py:run_telemetry_overhead gates).

``NULL_TELEMETRY`` / ``ensure_telemetry`` give components a uniform
"maybe instrumented" dependency without None checks at every site.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.telemetry.metrics import MetricsRegistry
from repro_torch.telemetry.tracing import NULL_SPAN, Tracer


class Telemetry:
    def __init__(self, enabled: bool = True, max_spans: int = 65536,
                 seed: int = 0):
        self.enabled = enabled
        self.registry = MetricsRegistry(seed=seed)
        self.tracer = Tracer(max_spans=max_spans)

    # -- tracing -----------------------------------------------------------
    def span(self, name: str, **attrs):
        if not self.enabled:
            return NULL_SPAN
        return self.tracer.span(name, **attrs)

    # -- metrics -----------------------------------------------------------
    def inc(self, name: str, value: float = 1.0, **labels) -> None:
        if self.enabled:
            self.registry.inc(name, value, **labels)

    def set_gauge(self, name: str, value: float, **labels) -> None:
        if self.enabled:
            self.registry.set_gauge(name, value, **labels)

    def observe(self, name: str, value: float, **labels) -> None:
        if self.enabled:
            self.registry.observe(name, value, **labels)

    def snapshot(self) -> dict:
        return self.registry.snapshot()


#: Shared disabled instance — writers are no-ops, never read from.
NULL_TELEMETRY = Telemetry(enabled=False, max_spans=1)


def ensure_telemetry(tel: Optional[Telemetry]) -> Telemetry:
    """Uniform dependency: a real plane when given one, else the null."""
    return tel if tel is not None else NULL_TELEMETRY
