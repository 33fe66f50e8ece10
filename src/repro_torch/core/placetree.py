"""ClientPlaceTree: logical tree model of the trainer device mesh (§4.1).

The tree has one level per parallelism axis, ordered outermost->innermost
(e.g. PP -> DP -> CP -> TP).  Leaves are trainer clients (global ranks).
It answers the two questions the data plane needs:

  * distribute(axis): how many independent data consumers exist at an axis
    (and which clients sit under each), including ``group_size`` coarsening
    for super-large clusters;
  * client_view(rank): which *view* of the batch a given client receives —
    the parallelism transformation (full data / CP slice / metadata-only /
    suppressed-by-broadcast), per paper §2.1 + Fig. 6.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence


@dataclasses.dataclass(frozen=True)
class ClientView:
    """What one trainer client receives for a step."""
    rank: int
    coords: dict                  # axis -> index
    role: str                     # "data" | "metadata" | "none"
    cp_rank: int = 0
    cp_degree: int = 1
    dp_index: int = 0             # which DP bucket this client consumes


class ClientPlaceTree:
    def __init__(self, axes: Sequence[tuple[str, int]]):
        """axes: ordered (name, size), outermost first.
        Example: [("PP", 4), ("DP", 8), ("CP", 2), ("TP", 4)]."""
        if not axes:
            raise ValueError("need at least one axis")
        self.axes = list(axes)
        self.names = [a for a, _ in axes]
        self.sizes = {a: s for a, s in axes}
        self.world = math.prod(s for _, s in axes)
        self._broadcast_axes: set[str] = set()

    # -- coordinates ------------------------------------------------------
    def coords(self, rank: int) -> dict:
        out = {}
        rem = rank
        for name, size in reversed(self.axes):
            out[name] = rem % size
            rem //= size
        return out

    def rank_of(self, coords: dict) -> int:
        r = 0
        for name, size in self.axes:
            r = r * size + coords.get(name, 0)
        return r

    def nodes_at(self, axis: str) -> int:
        """Number of buckets when distributing along ``axis``: the product
        of sizes from the root down to and including ``axis``, ignoring
        axes that merely replicate data (TP) below it."""
        if axis == "WORLD":
            return self.world
        if axis not in self.sizes:
            raise KeyError(f"unknown axis {axis!r}; have {self.names}")
        n = 1
        for name, size in self.axes:
            n *= size
            if name == axis:
                return n
        return n

    def buckets(self, axis: str, group_size: Optional[int] = None) -> int:
        n = self.nodes_at(axis)
        if group_size:
            return math.ceil(n / group_size)
        return n

    def clients_under(self, axis: str, bucket: int) -> list[int]:
        """Global ranks beneath one bucket at ``axis``."""
        if axis == "WORLD":
            return [bucket]
        per = self.world // self.nodes_at(axis)
        return list(range(bucket * per, (bucket + 1) * per))

    # -- parallelism transformation ----------------------------------------
    def set_broadcast(self, axes: Sequence[str]):
        """broadcast_at(): trainer broadcasts along these axes; only the
        0-index client of each fetches (paper §4.2/§6.2)."""
        for a in axes:
            if a != "WORLD" and a not in self.sizes:
                raise KeyError(f"unknown axis {a!r}")
        self._broadcast_axes = set(axes)

    def client_view(self, rank: int, distribute_axis: str = "DP") -> \
            ClientView:
        c = self.coords(rank)
        # broadcast suppression: only the 0th member along broadcast axes
        # fetches data
        for a in self._broadcast_axes:
            if c.get(a, 0) != 0:
                return ClientView(rank, c, role="none")
        # pipeline: stages > 0 get metadata only
        if "PP" in self.sizes and c.get("PP", 0) != 0:
            return ClientView(rank, c, role="metadata")
        cp = self.sizes.get("CP", 1)
        # which DP bucket: index of this client's bucket at distribute axis
        per = self.world // self.nodes_at(distribute_axis) \
            if distribute_axis != "WORLD" else 1
        dp_index = rank // per if per else rank
        return ClientView(rank, c, role="data", cp_rank=c.get("CP", 0),
                          cp_degree=cp, dp_index=dp_index)

    # -- summary ------------------------------------------------------------
    def data_fetching_clients(self, distribute_axis: str = "DP") -> list:
        return [r for r in range(self.world)
                if self.client_view(r, distribute_axis).role == "data"]

    def describe(self) -> str:
        parts = [f"{a}={s}" for a, s in self.axes]
        return f"ClientPlaceTree({' x '.join(parts)}, world={self.world}, " \
               f"broadcast={sorted(self._broadcast_axes)})"

    @classmethod
    def from_mesh(cls, mesh, pp: int = 1, cp: int = 1):
        """Build from a jax Mesh: ('pod','data') -> DP, 'model' -> TP, with
        explicit PP/CP factors carved out of DP if requested."""
        import math as _m
        dp = 1
        for a in ("pod", "data"):
            if a in mesh.axis_names:
                dp *= mesh.shape[a]
        tp = mesh.shape.get("model", 1)
        assert dp % (pp * cp) == 0, (dp, pp, cp)
        dp //= (pp * cp)
        return cls([("PP", pp), ("DP", dp), ("CP", cp), ("TP", tp)])
