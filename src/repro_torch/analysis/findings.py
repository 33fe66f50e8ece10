"""Typed findings for the static data-plane analyzers.

Every analyzer in ``repro.analysis`` reports through a ``Report`` of
``Finding`` objects — a rule id (stable, documented in docs/ANALYSIS.md),
a severity, a human message, a location, and a fix hint.  ERROR findings
are launch blockers: the CLI exits non-zero and ``Overlord(validate=True)``
raises ``AnalysisError``; WARNING/INFO findings are surfaced but never
block.
"""
from __future__ import annotations

import dataclasses
import enum
import json
from typing import Iterable, Optional, Sequence


class Severity(enum.IntEnum):
    INFO = 0
    WARNING = 1
    ERROR = 2

    def __str__(self) -> str:  # "error", not "Severity.ERROR"
        return self.name.lower()


@dataclasses.dataclass(frozen=True)
class Finding:
    rule: str                    # stable id, e.g. "DG102"
    severity: Severity
    message: str                 # what is wrong
    where: str = ""              # file:line / object path / config name
    hint: str = ""               # how to fix it

    def as_dict(self) -> dict:
        return {"rule": self.rule, "severity": str(self.severity),
                "message": self.message, "where": self.where,
                "hint": self.hint}

    def render(self) -> str:
        loc = f" [{self.where}]" if self.where else ""
        hint = f"\n    hint: {self.hint}" if self.hint else ""
        return f"{self.rule} {self.severity}:{loc} {self.message}{hint}"


class Report:
    """Accumulates findings; rules in ``disabled`` are dropped at add()."""

    def __init__(self, disabled: Iterable[str] = ()):
        self.disabled = {d.strip().upper() for d in disabled if d.strip()}
        self.findings: list[Finding] = []

    def add(self, rule: str, severity: Severity, message: str,
            where: str = "", hint: str = "") -> Optional[Finding]:
        if rule.upper() in self.disabled:
            return None
        f = Finding(rule, severity, message, where, hint)
        self.findings.append(f)
        return f

    def extend(self, other: "Report") -> "Report":
        for f in other.findings:
            if f.rule.upper() not in self.disabled:
                self.findings.append(f)
        return self

    # -- queries ----------------------------------------------------------
    @property
    def errors(self) -> list[Finding]:
        return [f for f in self.findings if f.severity >= Severity.ERROR]

    @property
    def warnings(self) -> list[Finding]:
        return [f for f in self.findings if f.severity == Severity.WARNING]

    @property
    def ok(self) -> bool:
        return not self.errors

    def by_rule(self, rule: str) -> list[Finding]:
        return [f for f in self.findings if f.rule == rule]

    def __len__(self) -> int:
        return len(self.findings)

    # -- rendering ---------------------------------------------------------
    def as_text(self) -> str:
        if not self.findings:
            return "analysis: clean (0 findings)"
        lines = [f.render() for f in sorted(
            self.findings, key=lambda f: (-int(f.severity), f.rule))]
        lines.append(f"analysis: {len(self.errors)} error(s), "
                     f"{len(self.warnings)} warning(s), "
                     f"{len(self.findings)} total")
        return "\n".join(lines)

    def as_json(self) -> str:
        return json.dumps({
            "errors": len(self.errors),
            "warnings": len(self.warnings),
            "findings": [f.as_dict() for f in self.findings],
        }, indent=2)


class AnalysisError(RuntimeError):
    """Raised by launch-time validation when ERROR findings exist."""

    def __init__(self, report: Report):
        self.report = report
        n = len(report.errors)
        super().__init__(
            f"static analysis found {n} launch-blocking problem(s):\n"
            + "\n".join(f.render() for f in report.errors))


def make_report(report: Optional[Report] = None,
                disabled: Sequence[str] = ()) -> Report:
    return report if report is not None else Report(disabled)
