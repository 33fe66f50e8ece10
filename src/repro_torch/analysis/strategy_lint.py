"""Strategy-contract linter (rule family ST2xx).

A strategy is ``fn(ctx: Orchestration, *, schedule, total, **params) ->
LoadingPlan``.  This module checks every ``STRATEGIES`` entry against
that contract statically: the signature via ``inspect`` and the body via
``ast`` (primitive call order, return shape, typo'd primitives) — so a
bad composition fails at lint/launch time instead of hanging the first
training step.
"""
from __future__ import annotations

import ast
import inspect
import textwrap
from typing import Callable, Optional

from repro_torch.analysis.findings import Report, Severity, make_report
from repro_torch.core.primitives import Orchestration

# the declarative surface a strategy may invoke on ctx
CTX_PRIMITIVES = {name for name in dir(Orchestration)
                  if not name.startswith("__")}
# primitives that must precede others (caller line order)
_ORDER_RULES = [
    ("mix", "plan", "plan() emits the LoadingPlan; only mix()ed samples "
                    "participate in orchestration"),
    ("mix", "dgraph", "dgraph() snapshots the mix() selection; building "
                      "it first plans over the raw buffer"),
    ("distribute", "balance", "balance() needs the bucket count that "
                              "distribute() declares"),
    ("cost", "balance", "balance() packs by per-sample cost; without "
                        "cost() every sample weighs 0"),
]


def _ctx_param(fn: Callable) -> Optional[str]:
    try:
        sig = inspect.signature(fn)
    except (TypeError, ValueError):
        return None
    params = list(sig.parameters.values())
    return params[0].name if params else None


def lint_strategy(name: str, fn: Callable,
                  report: Optional[Report] = None) -> Report:
    rep = make_report(report)
    where = f"strategy:{name}"

    # ---- signature contract (inspect) --------------------------------
    try:
        sig = inspect.signature(fn)
    except (TypeError, ValueError):
        rep.add("ST207", Severity.WARNING,
                f"strategy {name!r} has no introspectable signature",
                where, "wrap builtins/partials in a def with the "
                       "(ctx, *, schedule, total, ...) contract")
        return rep
    params = list(sig.parameters.values())
    if not params or params[0].kind not in (
            inspect.Parameter.POSITIONAL_ONLY,
            inspect.Parameter.POSITIONAL_OR_KEYWORD):
        rep.add("ST201", Severity.ERROR,
                f"strategy {name!r} must take the Orchestration ctx as "
                "its first positional parameter", where,
                "def strategy(ctx, *, schedule, total, ...)")
    for required in ("schedule", "total"):
        if required not in sig.parameters:
            rep.add("ST201", Severity.ERROR,
                    f"strategy {name!r} does not accept {required!r} "
                    "(the Planner always passes it)", where,
                    "add a keyword-only parameter "
                    f"'{required}' to the signature")
    for p in params[1:]:
        if p.kind == inspect.Parameter.POSITIONAL_OR_KEYWORD:
            rep.add("ST201", Severity.ERROR,
                    f"strategy {name!r} parameter {p.name!r} must be "
                    "keyword-only", where,
                    "insert '*' after ctx: strategy params travel as "
                    "**strategy_params and positional ones silently "
                    "shadow them")
    ret = sig.return_annotation
    ret_name = getattr(ret, "__name__", str(ret))
    if ret is inspect.Signature.empty or "LoadingPlan" not in ret_name:
        rep.add("ST202", Severity.WARNING,
                f"strategy {name!r} is not annotated '-> LoadingPlan'",
                where, "annotate the return type so the contract is "
                       "explicit")

    # ---- body contract (ast) -----------------------------------------
    try:
        src = textwrap.dedent(inspect.getsource(fn))
        tree = ast.parse(src)
    except (OSError, TypeError, SyntaxError):
        rep.add("ST207", Severity.WARNING,
                f"strategy {name!r} has no retrievable source; body "
                "rules skipped", where, "")
        return rep
    fdef = next((n for n in ast.walk(tree)
                 if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))),
                None)
    if fdef is None:
        return rep
    ctx_name = _ctx_param(fn) or "ctx"

    calls: dict[str, list[int]] = {}
    for node in ast.walk(fdef):
        if isinstance(node, ast.Call) \
                and isinstance(node.func, ast.Attribute) \
                and isinstance(node.func.value, ast.Name) \
                and node.func.value.id == ctx_name:
            prim = node.func.attr
            calls.setdefault(prim, []).append(node.lineno)
            # ST206 — typo'd / unknown primitive would AttributeError at
            # plan time (inside the Planner actor, i.e. a wedged step)
            if prim not in CTX_PRIMITIVES:
                rep.add("ST206", Severity.ERROR,
                        f"strategy {name!r} calls unknown primitive "
                        f"ctx.{prim}() (line {node.lineno})",
                        f"{where}:{node.lineno}",
                        f"known primitives: "
                        f"{sorted(p for p in CTX_PRIMITIVES if not p.startswith('_'))}")

    # ST204 — mix() is mandatory: it defines what this step trains on
    if "mix" not in calls:
        rep.add("ST204", Severity.ERROR,
                f"strategy {name!r} never calls ctx.mix()", where,
                "call ctx.mix(schedule, total) before building dgraphs; "
                "otherwise the whole loader buffer is planned verbatim")

    # ST205 — primitive ordering
    for first, then, why in _ORDER_RULES:
        if then in calls and first in calls:
            if min(calls[first]) > min(calls[then]):
                rep.add("ST205", Severity.ERROR,
                        f"strategy {name!r} calls ctx.{then}() before "
                        f"ctx.{first}()", where, why)
        elif then in calls and first not in calls \
                and (first, then) == ("distribute", "balance"):
            # cost-before-balance only applies when both appear, and a
            # missing mix() is already ST204; distribute() is the one
            # hard prerequisite reported here
            rep.add("ST205", Severity.ERROR,
                    f"strategy {name!r} calls ctx.{then}() but never "
                    f"ctx.{first}()", where, why)

    # ST203 — every return must hand back a LoadingPlan-shaped value:
    # ctx.plan(...), plan_raw(...), or a LoadingPlan(...) constructor
    for node in ast.walk(fdef):
        if not isinstance(node, ast.Return):
            continue
        v = node.value
        ok = False
        if isinstance(v, ast.Call):
            f = v.func
            if isinstance(f, ast.Attribute) and f.attr == "plan":
                ok = True
            if isinstance(f, ast.Name) and f.id in ("plan_raw",
                                                    "LoadingPlan"):
                ok = True
        elif isinstance(v, ast.Name):
            ok = True   # returning a local; shape not statically known
        if not ok:
            rep.add("ST203", Severity.ERROR,
                    f"strategy {name!r} return at line {node.lineno} is "
                    "not a LoadingPlan (expected ctx.plan(...) / "
                    "plan_raw(...))", f"{where}:{node.lineno}",
                    "the Planner executes the returned plan's entries; "
                    "anything else raises inside the actor thread")
    return rep


def lint_strategies(strategies: Optional[dict] = None,
                    report: Optional[Report] = None) -> Report:
    """Lint a STRATEGIES registry (defaults to the shipped one)."""
    rep = make_report(report)
    if strategies is None:
        from repro_torch.core.strategies import STRATEGIES
        strategies = STRATEGIES
    for name, fn in strategies.items():
        lint_strategy(name, fn, rep)
    return rep
