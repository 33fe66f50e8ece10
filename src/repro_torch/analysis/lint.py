"""CLI: static data-plane lint.

    python -m repro.analysis.lint [paths...] [--format text|json]
                                  [--disable DG108,CFG307] [--strict]

With no paths the full shipped surface is linted: the STRATEGIES
registry, every registered model config, the default OverlordConfig
against a representative client tree, and an actor-concurrency scan of
``src/repro``.  Paths may be .py files or directories: directories are
scanned for Actor subclasses; .py files are additionally imported so
``ModelConfig`` / ``OverlordConfig`` / ``STRATEGIES`` objects they
define get cross-validated (this is how CI lints config fixtures).

Exit status: 0 when no ERROR findings remain, 1 otherwise
(``--strict`` also fails on warnings).
"""
from __future__ import annotations

import argparse
import importlib.util
import os
import sys
from typing import Optional

from repro_torch.analysis.actor_lint import lint_actor_paths, lint_actor_source
from repro_torch.analysis.perf_lint import lint_perf_paths, lint_perf_source
from repro_torch.analysis.telemetry_lint import (
    lint_observability_paths, lint_observability_source,
)
from repro_torch.analysis.config_lint import (
    lint_model_config, lint_overlord_config, lint_shipped_model_configs,
)
from repro_torch.analysis.findings import Report, Severity
from repro_torch.analysis.strategy_lint import lint_strategies, lint_strategy
from repro_torch.configs.base import ModelConfig
from repro_torch.core.orchestrator import OverlordConfig
from repro_torch.core.placetree import ClientPlaceTree


def default_tree() -> ClientPlaceTree:
    """Representative topology for tree-dependent config rules."""
    return ClientPlaceTree([("PP", 1), ("DP", 4), ("CP", 1), ("TP", 1)])


def lint_default_surface(rep: Report) -> Report:
    lint_strategies(report=rep)
    lint_shipped_model_configs(report=rep)
    # representative launch config (the bare OverlordConfig() default has
    # no costfn and is deliberately rejected by CFG304 — see quickstart)
    cfg = OverlordConfig(strategy_params=dict(
        costfn=lambda meta: float(meta.get("text_tokens", 1))))
    lint_overlord_config(cfg, tree=default_tree(), n_sources=4,
                         report=rep)
    return rep


def _import_path(path: str):
    name = "_repro_lint_" + os.path.splitext(
        os.path.basename(path))[0].replace("-", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise ImportError(path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    try:
        spec.loader.exec_module(mod)
    finally:
        sys.modules.pop(name, None)
    return mod


def lint_python_file(path: str, rep: Report) -> Report:
    """Actor scan + import-based config/strategy validation of one file."""
    with open(path, encoding="utf-8") as f:
        src = f.read()
    lint_actor_source(src, path, rep)
    lint_observability_source(src, path, rep)
    lint_perf_source(src, path, rep)
    try:
        mod = _import_path(path)
    except BaseException as e:  # fixture may raise anything at import
        rep.add("CLI901", Severity.ERROR,
                f"cannot import {path}: {type(e).__name__}: {e}", path,
                "the file must be importable for config/strategy "
                "validation; actor rules above ran on the source only")
        return rep
    tree = default_tree()
    for attr in sorted(vars(mod)):
        obj = getattr(mod, attr)
        if isinstance(obj, ModelConfig):
            lint_model_config(obj, rep)
        elif isinstance(obj, OverlordConfig):
            lint_overlord_config(obj, tree=tree, report=rep)
    strategies = getattr(mod, "STRATEGIES", None)
    if isinstance(strategies, dict):
        for name, fn in strategies.items():
            if callable(fn):
                lint_strategy(str(name), fn, rep)
    return rep


def run(paths: list[str], disabled: list[str]) -> Report:
    rep = Report(disabled)
    if not paths:
        lint_default_surface(rep)
        src = os.path.join(os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__)))))
        lint_actor_paths([src], rep)
        lint_observability_paths([src], rep)
        lint_perf_paths([src], rep)
        return rep
    for p in paths:
        if os.path.isdir(p):
            for root, _dirs, files in os.walk(p):
                in_configs = os.path.basename(root) == "configs"
                for fn in sorted(files):
                    if not fn.endswith(".py"):
                        continue
                    full = os.path.join(root, fn)
                    if in_configs:
                        # config packages get the full import-based
                        # ModelConfig / OverlordConfig validation
                        lint_python_file(full, rep)
                    else:
                        lint_actor_paths([full], rep)
                        lint_observability_paths([full], rep)
                        lint_perf_paths([full], rep)
        elif p.endswith(".py"):
            lint_python_file(p, rep)
        else:
            rep.add("CLI902", Severity.ERROR,
                    f"unsupported path {p!r} (expected .py file or "
                    "directory)", p, "")
    return rep


def main(argv: Optional[list[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro.analysis.lint",
        description="static linter for the OVERLORD data plane")
    ap.add_argument("paths", nargs="*",
                    help=".py files or directories; default: full "
                         "shipped surface")
    ap.add_argument("--format", choices=("text", "json"), default="text")
    ap.add_argument("--disable", default="",
                    help="comma-separated rule ids to suppress")
    ap.add_argument("--strict", action="store_true",
                    help="exit non-zero on warnings too")
    args = ap.parse_args(argv)

    rep = run(args.paths, args.disable.split(","))
    print(rep.as_json() if args.format == "json" else rep.as_text())
    failed = rep.errors or (args.strict and rep.warnings)
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
