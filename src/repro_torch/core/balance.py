"""Balancing methods for the ``balance()`` primitive (paper §4.2).

Both operate on (cost, item) pairs and return bin assignments minimizing
the max-bin cost (the straggler — what sets step time under quadratic
attention).  ``greedy_binpack`` is LPT (4/3-approx); ``karmarkar_karp``
is the multiway differencing method (better for few large bins).

The public functions are the vectorized implementations (numpy argsort +
heap, cons-tree merges); the originals are kept as ``_*_reference`` and
exported through ``REFERENCE_METHODS`` so the equivalence tests in
tests/test_balance.py can check assignments item-for-item on randomized
inputs.  Each vectorized version is bit-equivalent by construction: same
stable orderings, same float operation order, same tie-breaking.
"""
from __future__ import annotations

import heapq
import itertools
from typing import Callable, Optional, Sequence

import numpy as np


# --------------------------------------------------------------- reference
def _greedy_binpack_reference(costs: Sequence[float],
                              n_bins: int) -> list[int]:
    """Original LPT: Python sort + heap (kept for equivalence tests)."""
    if n_bins <= 0:
        raise ValueError("n_bins must be positive")
    order = sorted(range(len(costs)), key=lambda i: -costs[i])
    heap = [(0.0, b) for b in range(n_bins)]
    heapq.heapify(heap)
    assign = [0] * len(costs)
    for i in order:
        load, b = heapq.heappop(heap)
        assign[i] = b
        heapq.heappush(heap, (load + costs[i], b))
    return assign


def _karmarkar_karp_reference(costs: Sequence[float],
                              n_bins: int) -> list[int]:
    """Original multiway differencing with eager per-merge tuple
    concatenation — O(n) extra work per merge (kept for tests)."""
    if n_bins <= 0:
        raise ValueError("n_bins must be positive")
    n = len(costs)
    if n == 0:
        return []
    counter = itertools.count()
    heap = []
    for i, c in enumerate(costs):
        loads = tuple([float(c)] + [0.0] * (n_bins - 1))
        bins = tuple([(i,)] + [()] * (n_bins - 1))
        heapq.heappush(heap, (-(loads[0] - loads[-1]), next(counter),
                              loads, bins))
    while len(heap) > 1:
        _, _, l1, b1 = heapq.heappop(heap)
        _, _, l2, b2 = heapq.heappop(heap)
        loads = [l1[i] + l2[n_bins - 1 - i] for i in range(n_bins)]
        bins = [b1[i] + b2[n_bins - 1 - i] for i in range(n_bins)]
        order = sorted(range(n_bins), key=lambda i: -loads[i])
        loads_t = tuple(loads[i] for i in order)
        bins_t = tuple(bins[i] for i in order)
        heapq.heappush(heap, (-(loads_t[0] - loads_t[-1]), next(counter),
                              loads_t, bins_t))
    _, _, loads, bins = heap[0]
    assign = [0] * n
    for b, items in enumerate(bins):
        for i in items:
            assign[i] = b
    return assign


def _multi_greedy_binpack_reference(
        cost_vectors: Sequence[Sequence[float]], n_bins: int) -> list[int]:
    """Original hybrid balance with the O(n·k·d) per-item bin rescan
    (kept for tests)."""
    if n_bins <= 0:
        raise ValueError("n_bins must be positive")
    n = len(cost_vectors)
    if n == 0:
        return []
    dims = len(cost_vectors[0])
    means = [max(sum(v[d] for v in cost_vectors) / n, 1e-12)
             for d in range(dims)]
    norm = [[v[d] / means[d] for d in range(dims)] for v in cost_vectors]
    order = sorted(range(n), key=lambda i: -max(norm[i]))
    loads = [[0.0] * dims for _ in range(n_bins)]
    assign = [0] * n
    for i in order:
        best, best_val = 0, float("inf")
        for b in range(n_bins):
            val = max(loads[b][d] + norm[i][d] for d in range(dims))
            if val < best_val:
                best, best_val = b, val
        assign[i] = best
        for d in range(dims):
            loads[best][d] += norm[i][d]
    return assign


# -------------------------------------------------------------- vectorized
def greedy_binpack(costs: Sequence[float], n_bins: int) -> list[int]:
    """Longest-processing-time-first.  Returns bin index per item.

    Vectorized ordering: one stable numpy argsort replaces the Python
    keyed sort (identical order — stable descending by cost, original
    index breaking ties), then the same lightest-bin heap placement."""
    if n_bins <= 0:
        raise ValueError("n_bins must be positive")
    n = len(costs)
    if n == 0:
        return []
    arr = np.asarray(costs, dtype=float)
    order = np.argsort(-arr, kind="stable")
    heap = [(0.0, b) for b in range(n_bins)]
    # already sorted ascending by construction — no heapify needed
    assign = [0] * n
    for i in order:
        load, b = heap[0]
        assign[i] = b
        heapq.heapreplace(heap, (load + float(arr[i]), b))
    return assign


def karmarkar_karp(costs: Sequence[float], n_bins: int) -> list[int]:
    """Multiway Karmarkar-Karp differencing.

    Maintains a heap of partial solutions (tuples of per-bin loads with
    the item sets); repeatedly merges the two largest by combining the
    largest bin with the smallest bin.

    The item sets are cons trees (nested pairs) materialized once at the
    end, so each merge is O(k) instead of O(n + k log k) from eager tuple
    concatenation.  Heap keys (spread, insertion counter) are identical
    to the reference, so pop order — and therefore every assignment — is
    identical."""
    if n_bins <= 0:
        raise ValueError("n_bins must be positive")
    n = len(costs)
    if n == 0:
        return []
    counter = itertools.count()
    # heap entry: (-spread, tiebreak, loads tuple desc, bins tuple of
    # cons trees aligned with loads).  The unique tiebreak means the
    # trees never participate in comparisons.
    heap = [(-float(c), next(counter),
             tuple([float(c)] + [0.0] * (n_bins - 1)),
             tuple([(i, None)] + [None] * (n_bins - 1)))
            for i, c in enumerate(costs)]
    heapq.heapify(heap)
    while len(heap) > 1:
        _, _, l1, b1 = heapq.heappop(heap)
        _, _, l2, b2 = heapq.heappop(heap)
        loads = [l1[i] + l2[n_bins - 1 - i] for i in range(n_bins)]
        bins = []
        for i in range(n_bins):
            a, b = b1[i], b2[n_bins - 1 - i]
            # cons: merge two trees in O(1) instead of tuple + tuple
            bins.append(a if b is None else b if a is None else (a, b))
        order = sorted(range(n_bins), key=lambda i: -loads[i])
        loads_t = tuple(loads[i] for i in order)
        bins_t = tuple(bins[i] for i in order)
        heapq.heappush(heap, (-(loads_t[0] - loads_t[-1]), next(counter),
                              loads_t, bins_t))
    _, _, loads, bins = heap[0]
    assign = [0] * n
    for b, tree in enumerate(bins):
        stack = [tree]
        while stack:
            node = stack.pop()
            if node is None:
                continue
            if isinstance(node[0], int):      # leaf: (item, None)
                assign[node[0]] = b
            else:
                stack.append(node[0])
                stack.append(node[1])
    return assign


def multi_greedy_binpack(cost_vectors: Sequence[Sequence[float]],
                         n_bins: int) -> list[int]:
    """Inter-module balancing: each item carries one cost per module
    (e.g. [encoder, backbone]); greedily place items (largest combined
    first) into the bin minimizing the worst per-module normalized load.
    This is the paper's hybrid balance: both module workloads must be
    flat simultaneously because the modules are colocated on the same
    GPUs.

    The inner placement scan is one numpy reduction over (bins, dims)
    instead of a Python double loop; per-dim means stay Python sums so
    normalization is bit-identical to the reference (np.sum pairwise
    accumulation would diverge in the last ulp)."""
    if n_bins <= 0:
        raise ValueError("n_bins must be positive")
    n = len(cost_vectors)
    if n == 0:
        return []
    dims = len(cost_vectors[0])
    means = np.array([max(sum(v[d] for v in cost_vectors) / n, 1e-12)
                      for d in range(dims)])
    norm = np.asarray(cost_vectors, dtype=float) / means
    order = np.argsort(-norm.max(axis=1), kind="stable")
    loads = np.zeros((n_bins, dims))
    assign = [0] * n
    for i in order:
        # argmin returns the FIRST minimal bin — same tie-break as the
        # reference's strict-< scan
        best = int(np.argmin((loads + norm[i]).max(axis=1)))
        assign[i] = best
        loads[best] += norm[i]
    return assign


METHODS: dict[str, Callable] = {
    "greedy_binpack": greedy_binpack,
    "karmarkar_karp": karmarkar_karp,
}

# original implementations, keyed like METHODS (equivalence tests)
REFERENCE_METHODS: dict[str, Callable] = {
    "greedy_binpack": _greedy_binpack_reference,
    "karmarkar_karp": _karmarkar_karp_reference,
    "multi_greedy_binpack": _multi_greedy_binpack_reference,
}


def balance_items(costs: Sequence[float], n_bins: int,
                  method: str = "greedy_binpack") -> list[int]:
    try:
        fn = METHODS[method]
    except KeyError:
        raise ValueError(
            f"unknown balance method {method!r}; have {sorted(METHODS)}")
    return fn(costs, n_bins)


def bin_loads(costs: Sequence[float], assign: Sequence[int],
              n_bins: int) -> list[float]:
    loads = [0.0] * n_bins
    for c, b in zip(costs, assign):
        loads[b] += c
    return loads


def imbalance(loads: Sequence[float]) -> float:
    """max/mean — 1.0 is perfect; the paper's Fig. 3 reports up to 6.9x."""
    m = sum(loads) / max(len(loads), 1)
    return max(loads) / m if m > 0 else 1.0
