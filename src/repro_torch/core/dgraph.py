"""DGraph: stateful dataflow graph over sample METADATA (paper §4.1).

Nodes are training samples in a processing state; DAG edges record
transformations / logical dependencies (microbatch grouping, bucket
assignment).  DGraph operates on metadata only — payloads never enter the
planner — which is what makes centralized orchestration cheap.

Two core properties from the paper:
  * unified multisource representation: several modality-specific graphs
    can be derived from the same buffer dict via ``select`` predicates
    (e.g. an image DGraph and a text DGraph over one VLM batch);
  * orchestration transparency: ``lineage()`` reconstructs every decision
    applied to a sample, ``to_dot()`` renders the graph.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Callable, Optional, Sequence

# node states (sample lifecycle)
BUFFERED = "buffered"        # sitting in a Source Loader read buffer
SELECTED = "selected"        # chosen by mix() for this step
COSTED = "costed"            # cost() annotated
BUCKETED = "bucketed"        # assigned to a distribute() bucket
BINNED = "binned"            # assigned to a microbatch bin
DELIVERED = "delivered"      # shipped to a Data Constructor


@dataclasses.dataclass
class DNode:
    nid: int
    meta: dict                       # sample metadata (source, sizes, ...)
    state: str = BUFFERED
    cost: float = 0.0
    bucket: Optional[int] = None     # distribute() bucket (e.g. DP rank)
    bin: Optional[int] = None        # microbatch index within bucket
    parents: list = dataclasses.field(default_factory=list)
    edges: list = dataclasses.field(default_factory=list)  # (label, nid)

    @property
    def sample_id(self) -> str:
        return self.meta["sample_id"]

    @property
    def source(self) -> str:
        return self.meta["source"]


class DGraph:
    def __init__(self, nodes: Sequence[DNode], name: str = "dgraph"):
        self.name = name
        self.nodes = list(nodes)
        self._by_id = {n.nid: n for n in self.nodes}

    # -- construction -----------------------------------------------------
    @classmethod
    def from_buffer(cls, buffer_meta: Sequence[dict], name: str = "dgraph",
                    select: Optional[Callable[[dict], bool]] = None) -> \
            "DGraph":
        """Build from Source Loader buffer metadata.  ``select`` carves a
        modality-specific view out of the shared dict (paper: image DGraph
        'inferred using the same buffer but different metadata')."""
        ids = itertools.count()
        nodes = [DNode(next(ids), dict(m)) for m in buffer_meta
                 if select is None or select(m)]
        return cls(nodes, name)

    def derive(self, name: str, select: Callable[[dict], bool]) -> "DGraph":
        """A sub-view sharing the SAME node objects (mutations visible in
        both graphs — one sample, several orchestration views)."""
        return DGraph([n for n in self.nodes if select(n.meta)], name)

    # -- state transitions --------------------------------------------------
    def mark(self, nodes: Sequence[DNode], state: str, label: str = ""):
        for n in nodes:
            n.edges.append((label or state, n.state))
            n.state = state

    def with_cost(self, costfn: Callable[[dict], float]):
        for n in self.nodes:
            n.cost = float(costfn(n.meta))
            n.edges.append(("cost", n.cost))
            n.state = COSTED
        return self

    def assign_buckets(self, assign: Sequence[int]):
        assert len(assign) == len(self.nodes)
        for n, b in zip(self.nodes, assign):
            n.bucket = int(b)
            n.edges.append(("bucket", int(b)))
            n.state = BUCKETED
        return self

    def assign_bins(self, nodes: Sequence[DNode], assign: Sequence[int]):
        for n, b in zip(nodes, assign):
            n.bin = int(b)
            n.edges.append(("bin", int(b)))
            n.state = BINNED
        return self

    # -- queries --------------------------------------------------------------
    def by_bucket(self) -> dict[int, list[DNode]]:
        out: dict[int, list[DNode]] = {}
        for n in self.nodes:
            if n.bucket is not None:
                out.setdefault(n.bucket, []).append(n)
        return out

    def by_source(self) -> dict[str, list[DNode]]:
        out: dict[str, list[DNode]] = {}
        for n in self.nodes:
            out.setdefault(n.source, []).append(n)
        return out

    def costs(self) -> list[float]:
        return [n.cost for n in self.nodes]

    def lineage(self, sample_id: str) -> list:
        for n in self.nodes:
            if n.sample_id == sample_id:
                return list(n.edges)
        raise KeyError(sample_id)

    # -- transparency -----------------------------------------------------------
    def to_dot(self, max_nodes: int = 40) -> str:
        lines = [f'digraph "{self.name}" {{']
        for n in self.nodes[:max_nodes]:
            lbl = f"{n.sample_id}\\n{n.state}"
            if n.bucket is not None:
                lbl += f"\\nbucket={n.bucket} bin={n.bin}"
            lines.append(f'  n{n.nid} [label="{lbl}"];')
        lines.append("}")
        return "\n".join(lines)

    def __len__(self) -> int:
        return len(self.nodes)
