"""Declarative orchestration primitives (paper §4.2) and LoadingPlan.

An ``Orchestration`` is created by the Planner per step from (a) buffer
metadata collected from Source Loaders and (b) the ClientPlaceTree.  The
user strategy calls the primitives — mix / distribute / cost / balance /
broadcast_at — then ``plan()`` emits the LoadingPlan that Source Loaders
and Data Constructors execute.  Fig. 9's two use cases are provided as
ready-made strategies in strategies.py.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import numpy as np

from repro_torch.core.balance import balance_items, bin_loads, imbalance
from repro_torch.core.dgraph import DGraph, SELECTED
from repro_torch.core.mixing import MixSchedule, sample_counts
from repro_torch.core.placetree import ClientPlaceTree


@dataclasses.dataclass
class PlanEntry:
    sample_id: str
    source: str
    bucket: int            # distribute() bucket (DP consumer index)
    bin: int               # microbatch index within the bucket


@dataclasses.dataclass
class LoadingPlan:
    step: int
    buckets: int
    bins: int
    entries: list                      # list[PlanEntry]
    distribute_axis: str = "DP"
    broadcast_axes: tuple = ()
    diagnostics: dict = dataclasses.field(default_factory=dict)

    def per_source(self) -> dict[str, list[PlanEntry]]:
        out: dict[str, list[PlanEntry]] = {}
        for e in self.entries:
            out.setdefault(e.source, []).append(e)
        return out

    def per_bucket(self) -> dict[int, list[PlanEntry]]:
        out: dict[int, list[PlanEntry]] = {}
        for e in self.entries:
            out.setdefault(e.bucket, []).append(e)
        return out


class Orchestration:
    def __init__(self, buffer_meta: Sequence[dict], tree: ClientPlaceTree,
                 step: int, seed: int = 0):
        self.buffer_meta = list(buffer_meta)
        self.tree = tree
        self.step = step
        self.rng = np.random.default_rng(hash((seed, step)) % 2**32)
        self._selected: list[dict] = []
        self._graphs: dict[str, DGraph] = {}
        self._n_buckets: Optional[int] = None
        self._distribute_axis = "DP"
        self._n_bins = 1
        self._costfn: Optional[Callable] = None
        self._broadcast: tuple = ()
        self._diag: dict = {}

    # ---------------------------------------------------------- mix()
    def mix(self, schedule: MixSchedule, total_samples: int) -> list[dict]:
        """Probabilistic source selection for this step.  Only sampled data
        participates in subsequent orchestration."""
        weights = schedule.weights(self.step)
        by_source: dict[str, list[dict]] = {}
        for m in self.buffer_meta:
            by_source.setdefault(m["source"], []).append(m)
        counts = sample_counts(
            {s: w for s, w in weights.items() if s in by_source},
            total_samples, self.rng)
        picked = []
        for src, k in counts.items():
            avail = by_source.get(src, [])
            picked.extend(avail[:k])   # FIFO from the loader buffer
        self._selected = picked
        self._diag["mix_weights"] = weights
        self._diag["mix_counts"] = {s: len([m for m in picked
                                            if m["source"] == s])
                                    for s in counts}
        return picked

    # -------------------------------------------------------- dgraph()
    def dgraph(self, name: str = "main",
               select: Optional[Callable[[dict], bool]] = None) -> DGraph:
        base = self._selected if self._selected else self.buffer_meta
        g = DGraph.from_buffer(base, name, select)
        g.mark(g.nodes, SELECTED, "mix")
        self._graphs[name] = g
        return g

    # ---------------------------------------------------- distribute()
    def distribute(self, axis: str = "DP",
                   group_size: Optional[int] = None) -> int:
        self._distribute_axis = axis
        self._n_buckets = self.tree.buckets(axis, group_size)
        return self._n_buckets

    def microbatches(self, n_bins: int) -> int:
        self._n_bins = max(int(n_bins), 1)
        return self._n_bins

    # ---------------------------------------------------------- cost()
    def cost(self, costfn: Callable[[dict], float],
             graph: Optional[DGraph] = None):
        self._costfn = costfn
        for g in ([graph] if graph else self._graphs.values()):
            g.with_cost(costfn)

    # ------------------------------------------------------- balance()
    def balance(self, method: str = "greedy_binpack",
                level: str = "inter", graph: Optional[DGraph] = None,
                keep_buckets: bool = False) -> dict:
        """level:
          'inter'       — balance samples across buckets, then greedy
                          bins inside each bucket (inter-microbatch);
          'intra'       — buckets already fixed; only rebalance bins;
          'interleaved' — balance across all bucket*bin slots at once.
        ``keep_buckets=True`` preserves an earlier bucket assignment
        (used when combining encoder + backbone strategies)."""
        if self._n_buckets is None:
            raise RuntimeError("call distribute() before balance()")
        g = graph or self._graphs.get("main") \
            or next(iter(self._graphs.values()))
        costs = g.costs()
        nb, m = self._n_buckets, self._n_bins

        if level == "interleaved":
            assign = balance_items(costs, nb * m, method)
            g.assign_buckets([a // m for a in assign])
            g.assign_bins(g.nodes, [a % m for a in assign])
        else:
            if level == "inter" and not keep_buckets:
                g.assign_buckets(balance_items(costs, nb, method))
            elif g.nodes and g.nodes[0].bucket is None:
                # intra with no prior assignment: round-robin buckets
                g.assign_buckets([i % nb for i in range(len(g.nodes))])
            for b, nodes in g.by_bucket().items():
                sub = balance_items([n.cost for n in nodes], m, method)
                g.assign_bins(nodes, sub)

        loads = bin_loads(costs, [n.bucket for n in g.nodes], nb)
        diag = {"bucket_loads": loads, "imbalance": imbalance(loads),
                "method": method, "level": level}
        self._diag[f"balance:{g.name}"] = diag
        return diag

    # -------------------------------------------------- broadcast_at()
    def broadcast_at(self, *axes: str):
        self._broadcast = tuple(axes)
        self.tree.set_broadcast(axes)

    # ---------------------------------------------------------- plan()
    def plan(self, graph: Optional[DGraph] = None) -> LoadingPlan:
        g = graph or self._graphs.get("main") \
            or next(iter(self._graphs.values()))
        entries = [PlanEntry(n.sample_id, n.source,
                             int(n.bucket or 0), int(n.bin or 0))
                   for n in g.nodes]
        return LoadingPlan(
            step=self.step, buckets=self._n_buckets or 1,
            bins=self._n_bins, entries=entries,
            distribute_axis=self._distribute_axis,
            broadcast_axes=self._broadcast, diagnostics=dict(self._diag))


# --------------------------------------------------------------- low-level
def plan_raw(buffer_meta, tree, step, assign_fn) -> LoadingPlan:
    """Escape hatch (paper: plan_raw/loader_do_plan/constructor_do_plan):
    ``assign_fn(meta) -> (bucket, bin)`` programs the plan directly."""
    entries = []
    nb = mb = 1
    for m in buffer_meta:
        b, mbin = assign_fn(m)
        nb = max(nb, b + 1)
        mb = max(mb, mbin + 1)
        entries.append(PlanEntry(m["sample_id"], m["source"], b, mbin))
    return LoadingPlan(step=step, buckets=nb, bins=mb, entries=entries)
