"""Pipeline linter over DGraph instances (rule family DG1xx).

Validates the sample-lifecycle state machine
(BUFFERED -> SELECTED -> COSTED -> BUCKETED -> BINNED -> DELIVERED)
against each node's recorded edge history, checks bucket/bin membership
consistency, and detects cycles / dangling references in the DAG formed
by ``DNode.parents``.  Operates on metadata only — linting a planned step
is as cheap as planning it.
"""
from __future__ import annotations

from typing import Optional, Sequence

from repro_torch.analysis.findings import Report, Severity, make_report
from repro_torch.core.dgraph import (
    BINNED, BUCKETED, BUFFERED, COSTED, DELIVERED, DGraph, SELECTED,
)

# lifecycle order; transitions may skip forward (vanilla never costs)
# but never move backward.
LIFECYCLE = [BUFFERED, SELECTED, COSTED, BUCKETED, BINNED, DELIVERED]
_ORDER = {s: i for i, s in enumerate(LIFECYCLE)}

# edge labels written by DGraph mutators -> the state they imply
_LABEL_STATE = {
    "buffered": BUFFERED,
    "mix": SELECTED, "select": SELECTED, "selected": SELECTED,
    "cost": COSTED, "costed": COSTED,
    "bucket": BUCKETED, "bucketed": BUCKETED,
    "bin": BINNED, "binned": BINNED,
    "deliver": DELIVERED, "delivered": DELIVERED,
}


def _derived_states(node) -> list[str]:
    """Reconstruct the state sequence from the node's edge history."""
    out = []
    for label, _value in node.edges:
        state = _LABEL_STATE.get(str(label).lower())
        if state is not None:
            out.append(state)
    return out


def lint_dgraph(g: DGraph, *, n_buckets: Optional[int] = None,
                n_bins: Optional[int] = None,
                report: Optional[Report] = None) -> Report:
    rep = make_report(report)
    ids = {n.nid for n in g.nodes}
    seen_samples: dict[str, int] = {}

    for n in g.nodes:
        where = f"dgraph:{g.name}/node:{n.nid}"

        # DG101 — unknown lifecycle state
        if n.state not in _ORDER:
            rep.add("DG101", Severity.ERROR,
                    f"node {n.nid} ({n.meta.get('sample_id', '?')}) is in "
                    f"unknown state {n.state!r}",
                    where, f"states must be one of {LIFECYCLE}")
            continue

        # DG102 — state-machine regression in the recorded history
        seq = _derived_states(n)
        prev = -1
        for s in seq:
            if _ORDER[s] < prev:
                rep.add("DG102", Severity.ERROR,
                        f"node {n.nid} regressed to {s!r} after reaching "
                        f"{LIFECYCLE[prev]!r}",
                        where,
                        "apply mix/cost/distribute/pack in lifecycle "
                        "order; re-costing after bucketing balances on "
                        "stale costs")
                break
            prev = max(prev, _ORDER[s])

        # DG103 — membership fields inconsistent with the state field
        order = _ORDER[n.state]
        if order >= _ORDER[BUCKETED] and n.bucket is None:
            rep.add("DG103", Severity.ERROR,
                    f"node {n.nid} is {n.state!r} but has no bucket",
                    where, "assign_buckets() must cover every node that "
                           "reaches BUCKETED")
        if n.bucket is not None and order < _ORDER[BUCKETED]:
            rep.add("DG103", Severity.ERROR,
                    f"node {n.nid} has bucket={n.bucket} but state "
                    f"{n.state!r} predates BUCKETED", where,
                    "use assign_buckets() so state and membership agree")
        if order >= _ORDER[BINNED] and n.bin is None:
            rep.add("DG103", Severity.ERROR,
                    f"node {n.nid} is {n.state!r} but has no microbatch bin",
                    where, "assign_bins() must cover every node that "
                           "reaches BINNED")
        if n.bin is not None and n.bucket is None:
            rep.add("DG103", Severity.ERROR,
                    f"node {n.nid} has bin={n.bin} but no bucket "
                    "(orphaned microbatch member)", where,
                    "bins are defined within a bucket; assign buckets "
                    "first")

        # DG104 — bucket/bin index out of the declared range
        if n.bucket is not None and n_buckets is not None \
                and not (0 <= n.bucket < n_buckets):
            rep.add("DG104", Severity.ERROR,
                    f"node {n.nid} bucket={n.bucket} outside "
                    f"[0, {n_buckets})", where,
                    "distribute() declared fewer buckets than the "
                    "strategy assigned")
        if n.bin is not None and n_bins is not None \
                and not (0 <= n.bin < n_bins):
            rep.add("DG104", Severity.ERROR,
                    f"node {n.nid} bin={n.bin} outside [0, {n_bins})",
                    where, "microbatches() declared fewer bins than the "
                           "strategy assigned")

        # DG106 — dangling parent reference
        for p in n.parents:
            if p not in ids:
                rep.add("DG106", Severity.ERROR,
                        f"node {n.nid} references parent {p} not present "
                        f"in dgraph {g.name!r}", where,
                        "derive()d views share nodes; parents must stay "
                        "within the graph that owns the node")

        # DG107 — duplicate sample ids break lineage and plan ownership
        sid = n.meta.get("sample_id")
        if sid is not None:
            if sid in seen_samples:
                rep.add("DG107", Severity.ERROR,
                        f"duplicate sample_id {sid!r} "
                        f"(nodes {seen_samples[sid]} and {n.nid})", where,
                        "lineage() and the Planner's owner map assume "
                        "sample ids are unique per graph")
            else:
                seen_samples[sid] = n.nid

    # DG105 — cycle over parent edges (the DAG must stay a DAG)
    _check_cycles(g, ids, rep)

    # DG108 — orphans left behind once the graph reached packing
    if any(n.state in _ORDER and _ORDER[n.state] >= _ORDER[BINNED]
           for n in g.nodes):
        stragglers = [n.nid for n in g.nodes
                      if n.state in (SELECTED, COSTED)]
        if stragglers:
            rep.add("DG108", Severity.WARNING,
                    f"{len(stragglers)} node(s) stalled before BUCKETED "
                    f"while others reached BINNED (e.g. node "
                    f"{stragglers[0]})", f"dgraph:{g.name}",
                    "a strategy that bins any node should bin every "
                    "selected node or drop it explicitly")
    return rep


def _check_cycles(g: DGraph, ids: set, rep: Report):
    WHITE, GREY, BLACK = 0, 1, 2
    color = {nid: WHITE for nid in ids}
    by_id = {n.nid: n for n in g.nodes}
    for start in ids:
        if color[start] != WHITE:
            continue
        stack: list[tuple[int, int]] = [(start, 0)]
        color[start] = GREY
        while stack:
            nid, i = stack[-1]
            parents = [p for p in by_id[nid].parents if p in ids]
            if i < len(parents):
                stack[-1] = (nid, i + 1)
                p = parents[i]
                if color[p] == GREY:
                    rep.add("DG105", Severity.ERROR,
                            f"cycle through nodes {p} -> {nid} in dgraph "
                            f"{g.name!r}", f"dgraph:{g.name}/node:{nid}",
                            "the DGraph must stay acyclic: a sample "
                            "cannot depend on its own downstream "
                            "transformation")
                    return
                if color[p] == WHITE:
                    color[p] = GREY
                    stack.append((p, 0))
            else:
                color[nid] = BLACK
                stack.pop()


def lint_dgraphs(graphs: Sequence[DGraph],
                 report: Optional[Report] = None, **kw) -> Report:
    rep = make_report(report)
    for g in graphs:
        lint_dgraph(g, report=rep, **kw)
    return rep
