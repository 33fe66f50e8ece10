"""MultiSource Loader AutoScaling (§5).

Phase 1 (offline) — ``auto_partition``: cluster sources by transformation
cost, derive worker counts per resource level, and split heavy sources
into data-parallel loader actors, under per-source / per-actor worker
bounds and a memory budget.

Phase 2 (online) — ``MixtureScaler``: reacts to the Planner's
mixture-shift triggers by adding/removing data-parallel shards of a
source's loaders, resharding live (new actors join the next plan).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

from repro_torch.core.actors import ActorRuntime
from repro_torch.core.source_loader import SourceLoader


@dataclasses.dataclass(frozen=True)
class SourceProfile:
    name: str
    transform_cost: float      # mean per-sample cost (P_k)
    memory_bytes: int          # access-state footprint (M_k)
    weight: float = 1.0        # current mixture weight


@dataclasses.dataclass
class LoaderConfig:
    source: str
    shard_index: int
    shard_count: int
    workers: int

    @property
    def actor_name(self) -> str:
        return f"loader:{self.source}:{self.shard_index}of{self.shard_count}"


@dataclasses.dataclass(frozen=True)
class PartitionLimits:
    cluster_size: int = 4          # paper: 4 optimal in most scenarios
    w_src: int = 16                # per-source worker bound
    w_actor: int = 4               # per-actor worker bound
    total_workers: int = 64        # resource pool (minus constructor/planner)
    memory_budget: int = 1 << 34   # bytes


def auto_partition(profiles: list[SourceProfile],
                   limits: PartitionLimits = PartitionLimits()) -> \
        list[LoaderConfig]:
    """Three stages (paper §5.1): source clustering -> resource levels ->
    configuration generation."""
    if not profiles:
        return []
    # (1) cluster by descending transformation cost
    ordered = sorted(profiles, key=lambda p: -p.transform_cost)
    G = max(1, math.ceil(len(ordered) / limits.cluster_size))
    clusters = [ordered[i::G] for i in range(G)]
    clusters = [c for c in clusters if c]
    cluster_cost = [sum(p.transform_cost * max(p.weight, 1e-6) for p in c)
                    / len(c) for c in clusters]

    # (2) resource levels: workers proportional to relative cluster cost
    floor = min(cluster_cost)
    ratios = [c / max(floor, 1e-9) for c in cluster_cost]
    raw = [max(1.0, r) for r in ratios]
    scale = limits.total_workers / max(sum(
        raw[i] * len(clusters[i]) for i in range(len(clusters))), 1e-9)
    per_source_workers = [
        max(1, min(limits.w_src, int(raw[i] * scale)))
        for i in range(len(clusters))]

    # (3) configuration generation: split workers into actors of w_actor
    out: list[LoaderConfig] = []
    for ci, cluster in enumerate(clusters):
        w = per_source_workers[ci]
        n_actors = max(1, math.ceil(w / limits.w_actor))
        for p in cluster:
            # memory constraint: enough shards that per-actor access state
            # fits the budget share
            mem_shards = max(1, math.ceil(
                p.memory_bytes * n_actors / max(limits.memory_budget, 1)))
            shards = max(n_actors, mem_shards)
            wk = max(1, min(limits.w_actor, w // shards or 1))
            for i in range(shards):
                out.append(LoaderConfig(p.name, i, shards, wk))
    return out


class MixtureScaler:
    """Online phase: add/remove shards when the Planner fires triggers."""

    def __init__(self, runtime: ActorRuntime, paths: dict[str, str],
                 register: Callable, unregister: Callable,
                 max_shards: int = 8, workers: int = 2,
                 loader_factory: Optional[Callable] = None):
        self.runtime = runtime
        self.paths = paths
        self.register = register        # (name, handle) -> join planning
        self.unregister = unregister    # (name) -> leave planning
        # LoaderConfig -> SourceLoader; lets the Overlord hand resharded
        # loaders the shared retry/breaker/dlq/telemetry wiring instead
        # of spawning bare ones
        self.loader_factory = loader_factory
        self.max_shards = max_shards
        self.workers = workers
        self.shards: dict[str, int] = {}
        self.events: list[dict] = []

    def current_shards(self, source: str) -> int:
        return self.shards.get(source, 1)

    def on_trigger(self, source: str, direction: str):
        cur = self.current_shards(source)
        if direction == "up" and cur < self.max_shards:
            new = cur + 1
        elif direction == "down" and cur > 1:
            new = cur - 1
        else:
            return
        self.reshard(source, new)

    def reshard(self, source: str, shards: int):
        """Live reshard: spawn the new shard set, register, then retire the
        old actors (next plan uses the new buffers — no delivery gap)."""
        old = [n for n in self.runtime.actors()
               if n.startswith(f"loader:{source}:") and "::shadow" not in n]
        new_handles = {}
        for i in range(shards):
            cfg = LoaderConfig(source, i, shards, self.workers)
            if self.loader_factory is not None:
                loader = self.loader_factory(cfg)
            else:
                loader = SourceLoader(source, self.paths[source],
                                      (i, shards), cfg.workers)
            h = self.runtime.spawn(cfg.actor_name, loader)
            new_handles[cfg.actor_name] = h
        for name, h in new_handles.items():
            self.register(name, h)
        for name in old:
            if name not in new_handles:
                self.unregister(name)
                h = self.runtime.get(name)
                if h.alive:
                    h.stop()
        self.shards[source] = shards
        self.events.append({"source": source, "shards": shards})
