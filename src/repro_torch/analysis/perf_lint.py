"""Performance analyzer (rule family PERF7xx).

The pipelined planning path (docs/PERFORMANCE.md) exists because serial
actor round-trips stack up linearly: a loop over N handles that issues a
blocking ``h.call(...)`` per iteration pays N mailbox latencies where
one overlapped ``call_async`` wave (``FanOut``) pays ~1.

PERF701 flags exactly that shape in ``core/`` files: a synchronous
``.call(...)`` whose receiver is derived from the target of an enclosing
``for`` loop (i.e. the handle being iterated).  Loops that are serial on
purpose — operator introspection, the measured non-pipelined baseline —
opt out with a ``# perf: serial ok`` comment on the loop header, the
call line, or the line directly above the call.

``call_async``/``cast`` receivers never match (they do not block), and
neither does a blocking call on a FIXED handle inside a step loop
(``for step ...: self.planner.call(...)``) — that is one round-trip per
step, not per handle.
"""
from __future__ import annotations

import ast
import os
import re
from typing import Iterable, Optional

from repro_torch.analysis.findings import Report, Severity, make_report

#: opt-out annotation (anywhere in the comment text)
SERIAL_OK_RE = re.compile(r"#\s*perf:\s*serial\s+ok")


def _annotated_lines(source: str) -> set[int]:
    return {i for i, line in enumerate(source.splitlines(), start=1)
            if SERIAL_OK_RE.search(line)}


def _target_names(node: ast.AST) -> set[str]:
    """Names bound by a loop target (``for name, h in ...`` -> {name, h})."""
    out: set[str] = set()
    for sub in ast.walk(node):
        if isinstance(sub, ast.Name) and isinstance(sub.ctx, ast.Store):
            out.add(sub.id)
    return out


def _mentions_any(node: ast.AST, names: set[str]) -> bool:
    for sub in ast.walk(node):
        if isinstance(sub, ast.Name) and isinstance(sub.ctx, ast.Load) \
                and sub.id in names:
            return True
    return False


class _SerialCallLinter(ast.NodeVisitor):
    """PERF701 — blocking per-handle call() inside a loop over handles."""

    def __init__(self, where: str, rep: Report, annotated: set[int]):
        self.where = where
        self.rep = rep
        self.annotated = annotated
        # stack of (loop lineno, loop-bound names, loop annotated?)
        self._loops: list[tuple[int, set[str], bool]] = []

    def visit_For(self, node: ast.For):
        self._loops.append((node.lineno, _target_names(node.target),
                            node.lineno in self.annotated))
        for stmt in node.body:
            self.visit(stmt)
        self._loops.pop()
        for stmt in node.orelse:
            self.visit(stmt)

    visit_AsyncFor = visit_For

    def visit_Call(self, node: ast.Call):
        self.generic_visit(node)
        if not (isinstance(node.func, ast.Attribute)
                and node.func.attr == "call"):
            return
        recv = node.func.value
        for loop_line, names, loop_ok in self._loops:
            if not _mentions_any(recv, names):
                continue   # fixed receiver: per-step, not per-handle
            if loop_ok or node.lineno in self.annotated \
                    or (node.lineno - 1) in self.annotated:
                return
            self.rep.add(
                "PERF701", Severity.WARNING,
                f"blocking call() on loop handle at line {node.lineno} "
                f"inside the loop at line {loop_line} serializes one "
                "mailbox round-trip per handle",
                f"{self.where}:{node.lineno}",
                "issue call_async per handle and gather the futures "
                "(FanOut) so the wave overlaps, or annotate the loop "
                "with '# perf: serial ok' if serial is intentional")
            return


def _is_core_file(filename: str) -> bool:
    """PERF701 scope: files under a core/ directory, except the actor
    runtime itself (actors.py implements call() and the FanOut gather
    loop)."""
    parts = filename.replace(os.sep, "/").split("/")
    return "core" in parts[:-1] and parts[-1] != "actors.py"


def lint_perf_source(source: str, filename: str = "<string>",
                     report: Optional[Report] = None) -> Report:
    rep = make_report(report)
    if not _is_core_file(filename):
        return rep
    try:
        tree = ast.parse(source)
    except SyntaxError as e:
        rep.add("PERF700", Severity.ERROR,
                f"cannot parse {filename}: {e.msg} (line {e.lineno})",
                filename, "")
        return rep
    _SerialCallLinter(filename, rep, _annotated_lines(source)).visit(tree)
    return rep


def lint_perf_file(path: str, report: Optional[Report] = None) -> Report:
    rep = make_report(report)
    with open(path, encoding="utf-8") as f:
        return lint_perf_source(f.read(), path, rep)


def lint_perf_paths(paths: Iterable[str],
                    report: Optional[Report] = None) -> Report:
    rep = make_report(report)
    for p in paths:
        if os.path.isdir(p):
            for root, _dirs, files in os.walk(p):
                for fn in sorted(files):
                    if fn.endswith(".py"):
                        lint_perf_file(os.path.join(root, fn), rep)
        elif p.endswith(".py"):
            lint_perf_file(p, rep)
    return rep
