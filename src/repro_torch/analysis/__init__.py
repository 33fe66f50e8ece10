"""Static analysis for the OVERLORD data plane (docs/ANALYSIS.md).

Three analyzers, one finding model:

  * pipeline linter   — DGraph state machine + strategy contracts
                        (dgraph_lint, strategy_lint; rules DG1xx/ST2xx)
  * config validator  — OverlordConfig x ClientPlaceTree x ModelConfig
                        cross-checks (config_lint; rules CFG3xx/MDL4xx)
  * actor analyzer    — concurrency rules over Actor subclasses
                        (actor_lint; rules ACT5xx)
  * observability     — shared-counter hygiene in core/ files
                        (telemetry_lint; rules OBS6xx)
  * performance       — serial per-handle RPC loops in core/ files
                        (perf_lint; rules PERF7xx)

``validate_launch`` is the composition ``Overlord(validate=True)`` runs
before spawning anything; ``python -m repro.analysis.lint`` is the same
set of checks as a CI gate.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.analysis.actor_lint import (  # noqa: F401
    lint_actor_class, lint_actor_file, lint_actor_paths,
    lint_actor_source,
)
from repro_torch.analysis.config_lint import (  # noqa: F401
    lint_model_config, lint_overlord_config, lint_shipped_model_configs,
)
from repro_torch.analysis.dgraph_lint import (  # noqa: F401
    LIFECYCLE, lint_dgraph, lint_dgraphs,
)
from repro_torch.analysis.findings import (  # noqa: F401
    AnalysisError, Finding, Report, Severity,
)
from repro_torch.analysis.perf_lint import (  # noqa: F401
    lint_perf_file, lint_perf_paths, lint_perf_source,
)
from repro_torch.analysis.strategy_lint import (  # noqa: F401
    lint_strategies, lint_strategy,
)
from repro_torch.analysis.telemetry_lint import (  # noqa: F401
    lint_observability_file, lint_observability_paths,
    lint_observability_source,
)


def validate_launch(cfg, tree=None, n_sources: Optional[int] = None,
                    disabled=()) -> Report:
    """Launch-time validation: the selected strategy's contract plus the
    OverlordConfig cross-checks against the actual client tree."""
    from repro_torch.core.strategies import STRATEGIES
    rep = Report(disabled)
    lint_overlord_config(cfg, tree=tree, n_sources=n_sources, report=rep)
    fn = STRATEGIES.get(cfg.strategy)
    if fn is not None:
        lint_strategy(cfg.strategy, fn, rep)
    return rep
