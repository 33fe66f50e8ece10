# OVERLORD data plane — the paper's primary contribution.
from repro_torch.core.actors import Actor, ActorHandle, ActorRuntime  # noqa: F401
from repro_torch.core.balance import (  # noqa: F401
    balance_items, bin_loads, greedy_binpack, imbalance, karmarkar_karp,
    multi_greedy_binpack,
)
from repro_torch.core.dgraph import DGraph  # noqa: F401
from repro_torch.core.mixing import (  # noqa: F401
    AdaptiveSchedule, CurriculumSchedule, MixSchedule, StagedSchedule,
    StaticSchedule,
)
from repro_torch.core.orchestrator import Overlord, OverlordConfig  # noqa: F401
from repro_torch.core.placetree import ClientPlaceTree  # noqa: F401
from repro_torch.core.primitives import LoadingPlan, Orchestration  # noqa: F401
from repro_torch.core.resilience import (  # noqa: F401
    CircuitBreaker, CorruptSampleError, DeadLetterQueue, RetryPolicy,
    TransientIOError,
)
from repro_torch.core.strategies import STRATEGIES  # noqa: F401
