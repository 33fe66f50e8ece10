# Unified telemetry plane (docs/TELEMETRY.md): metrics + trace spans +
# export surfaces.  Dependency-free — importable from core, chaos, and
# analysis without cycles.
from repro_torch.telemetry.export import (  # noqa: F401
    canonical_spans, chrome_trace, parse_prometheus, render_prometheus,
    write_chrome_trace,
)
from repro_torch.telemetry.metrics import (  # noqa: F401
    Counter, Gauge, Histogram, MetricsRegistry, label_key, render_key,
)
from repro_torch.telemetry.plane import (  # noqa: F401
    NULL_TELEMETRY, Telemetry, ensure_telemetry,
)
from repro_torch.telemetry.tracing import NULL_SPAN, Span, Tracer  # noqa: F401
