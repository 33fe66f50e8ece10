"""Observability analyzer (rule family OBS6xx).

The telemetry plane (docs/TELEMETRY.md) gives every shared counter one
home: the ``MetricsRegistry``.  A data-plane component that reaches into
ANOTHER object and bumps a counter-looking attribute directly —
``self.dlq._total += 1`` — creates a second book of record that the
``telemetry_report()`` reconciliation can never audit, and mutates state
the owning object guards with its own lock (or mailbox thread).

OBS601 flags exactly that shape in ``core/`` files: an assignment or
augmented assignment whose target is a counter-named attribute reached
through a base other than ``self``/``cls``.  Mutating *your own*
counters (``self._dropped += 1``) is fine — that is the owner keeping
its books; the registry mirrors them via instrumented paths.
"""
from __future__ import annotations

import ast
import os
import re
from typing import Iterable, Optional

from repro_torch.analysis.findings import Report, Severity, make_report

#: attribute names that read as counters/tallies
COUNTER_NAME_RE = re.compile(
    r"(_total$)|(_counts?$)|(_failures$)|(_dropped$)|(_quarantined$)"
    r"|(^n_)|(_errors$)")


def _unwrap_target(node: ast.AST) -> Optional[ast.Attribute]:
    """Peel Subscripts (``x._counts[k]`` -> ``x._counts``) down to the
    attribute being mutated, if any."""
    while isinstance(node, ast.Subscript):
        node = node.value
    return node if isinstance(node, ast.Attribute) else None


def _flatten_targets(node: ast.AST) -> list:
    if isinstance(node, (ast.Tuple, ast.List)):
        out = []
        for elt in node.elts:
            out.extend(_flatten_targets(elt))
        return out
    return [node]


def _base_name(attr: ast.Attribute) -> str:
    """Rendered base expression of an attribute, e.g. ``self.dlq`` for
    ``self.dlq._total``."""
    try:
        return ast.unparse(attr.value)
    except Exception:  # pragma: no cover - unparse exists on 3.9+
        return "<expr>"


def _is_foreign_counter_write(attr: ast.Attribute) -> bool:
    if not COUNTER_NAME_RE.search(attr.attr):
        return False
    base = attr.value
    # self._dropped / cls._seen: the owner's own books — allowed
    if isinstance(base, ast.Name) and base.id in ("self", "cls"):
        return False
    return True


class _ObservabilityLinter(ast.NodeVisitor):
    def __init__(self, where: str, rep: Report):
        self.where = where
        self.rep = rep

    def _check_targets(self, targets: Iterable[ast.AST], lineno: int):
        for raw in targets:
            for t in _flatten_targets(raw):
                attr = _unwrap_target(t)
                if attr is None or not _is_foreign_counter_write(attr):
                    continue
                self.rep.add(
                    "OBS601", Severity.WARNING,
                    f"shared counter {_base_name(attr)}.{attr.attr} "
                    f"mutated directly at line {lineno}",
                    f"{self.where}:{lineno}",
                    "counters owned by another component must go through "
                    "its API or the telemetry MetricsRegistry "
                    "(inc/observe); direct writes bypass the owner's "
                    "locking and the telemetry_report() reconciliation")

    def visit_Assign(self, node: ast.Assign):
        self._check_targets(node.targets, node.lineno)
        self.generic_visit(node)

    def visit_AugAssign(self, node: ast.AugAssign):
        self._check_targets([node.target], node.lineno)
        self.generic_visit(node)

    def visit_AnnAssign(self, node: ast.AnnAssign):
        if node.value is not None:
            self._check_targets([node.target], node.lineno)
        self.generic_visit(node)


def _is_core_file(filename: str) -> bool:
    parts = filename.replace(os.sep, "/").split("/")
    return "core" in parts[:-1]


def lint_observability_source(source: str, filename: str = "<string>",
                              report: Optional[Report] = None) -> Report:
    rep = make_report(report)
    if not _is_core_file(filename):
        return rep
    try:
        tree = ast.parse(source)
    except SyntaxError as e:
        rep.add("OBS600", Severity.ERROR,
                f"cannot parse {filename}: {e.msg} (line {e.lineno})",
                filename, "")
        return rep
    _ObservabilityLinter(filename, rep).visit(tree)
    return rep


def lint_observability_file(path: str,
                            report: Optional[Report] = None) -> Report:
    rep = make_report(report)
    with open(path, encoding="utf-8") as f:
        return lint_observability_source(f.read(), path, rep)


def lint_observability_paths(paths: Iterable[str],
                             report: Optional[Report] = None) -> Report:
    rep = make_report(report)
    for p in paths:
        if os.path.isdir(p):
            for root, _dirs, files in os.walk(p):
                for fn in sorted(files):
                    if fn.endswith(".py"):
                        lint_observability_file(os.path.join(root, fn),
                                                rep)
        elif p.endswith(".py"):
            lint_observability_file(p, rep)
    return rep
