# Chaos harness: deterministic fault injection + delivery verification
# (docs/FAULT_TOLERANCE.md).  Layering: policies/schedules/ledger are
# dependency-free; only the injector imports repro.core.
from repro_torch.chaos.ledger import DeliveryLedger, LedgerViolation  # noqa: F401
from repro_torch.chaos.policies import (  # noqa: F401
    CircuitBreaker, CorruptSampleError, DeadLetterQueue, RetryPolicy,
    TransientIOError,
)
from repro_torch.chaos.schedules import FaultEvent, FaultSchedule  # noqa: F401
from repro_torch.chaos.injector import FaultInjector  # noqa: F401
