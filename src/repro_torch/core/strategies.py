"""Ready-made orchestration strategies (paper Fig. 9 + §7 baselines).

A strategy is ``fn(ctx: Orchestration, **params) -> LoadingPlan``.  The
three evaluation arms of the paper:

  * vanilla          — no scheduling (round-robin buckets)
  * backbone_balance — inter-microbatch balancing on the LLM backbone only
  * hybrid_balance   — interleaved encoder (image) balancing + backbone
                       balancing combined (the VLM strategy)
"""
from __future__ import annotations

from typing import Callable, Optional

from repro_torch.core.mixing import MixSchedule
from repro_torch.core.primitives import LoadingPlan, Orchestration


def vanilla(ctx: Orchestration, *, schedule: MixSchedule, total: int,
            n_bins: int = 1, costfn=None, axis: str = "DP") -> LoadingPlan:
    """No load balancing: FIFO round-robin over buckets (colocated-loader
    behaviour).  Cost annotations are kept so diagnostics can report the
    imbalance that WOULD have been avoided."""
    ctx.mix(schedule, total)
    g = ctx.dgraph("main")
    nb = ctx.distribute(axis)
    ctx.microbatches(n_bins)
    if costfn is not None:
        ctx.cost(costfn, g)
    g.assign_buckets([i % nb for i in range(len(g.nodes))])
    for b, nodes in g.by_bucket().items():
        g.assign_bins(nodes, [i % ctx._n_bins for i in range(len(nodes))])
    from repro_torch.core.balance import bin_loads, imbalance
    loads = bin_loads(g.costs(), [n.bucket for n in g.nodes], nb)
    ctx._diag["balance:main"] = {
        "bucket_loads": loads, "imbalance": imbalance(loads),
        "method": "none", "level": "none"}
    return ctx.plan(g)


def backbone_balance(ctx: Orchestration, *, schedule: MixSchedule,
                     total: int, costfn, n_bins: int = 1,
                     method: str = "greedy_binpack",
                     axis: str = "DP",
                     broadcast: tuple = ("TP",)) -> LoadingPlan:
    """Fig. 9 LLMBalance: distribute along DP, balance packed-sequence cost
    across DP buckets and microbatch bins."""
    ctx.mix(schedule, total)
    g = ctx.dgraph("main")
    ctx.distribute(axis)
    ctx.microbatches(n_bins)
    ctx.cost(costfn, g)
    ctx.balance(method, level="inter", graph=g)
    if broadcast:
        ctx.broadcast_at(*broadcast)
    return ctx.plan(g)


def hybrid_balance(ctx: Orchestration, *, schedule: MixSchedule,
                   total: int, backbone_costfn, encoder_costfn,
                   n_bins: int = 1, method: str = "greedy_binpack",
                   encoder_axis: str = "WORLD",
                   axis: str = "DP",
                   broadcast: tuple = ("TP",)) -> LoadingPlan:
    """Fig. 9 VLM strategy: the image DGraph is derived from the SAME
    buffer with different metadata; images are balanced across the
    encoder's (world-wide DP) consumers first, then the backbone balance
    runs over complete sequences with buckets preserved for image-heavy
    samples (inter-module balancing)."""
    from repro_torch.core.balance import (
        bin_loads, imbalance, multi_greedy_binpack,
    )

    ctx.mix(schedule, total)
    g = ctx.dgraph("main")
    # image DGraph: same buffer, different metadata (paper Fig. 9)
    img = g.derive("image", lambda m: m.get("image_tokens", 0) > 0)
    ctx._graphs["image"] = img
    ctx.cost(encoder_costfn, img)

    nb = ctx.distribute(axis)
    ctx.microbatches(n_bins)
    ctx.cost(backbone_costfn, g)

    # inter-module balance: each sample carries (encoder, backbone) costs;
    # minimize the worst per-module bucket load simultaneously (modules are
    # colocated, so both must be flat).
    enc_costs = {id(n): n.cost for n in img.nodes}
    vectors = [(enc_costs.get(id(n), 0.0), backbone_costfn(n.meta))
               for n in g.nodes]
    g.with_cost(backbone_costfn)
    g.assign_buckets(multi_greedy_binpack(vectors, nb))
    idx = {id(n): i for i, n in enumerate(g.nodes)}
    for b, nodes in g.by_bucket().items():
        sub = multi_greedy_binpack(
            [vectors[idx[id(n)]] for n in nodes], ctx._n_bins)
        g.assign_bins(nodes, sub)

    bb_loads = bin_loads([v[1] for v in vectors],
                         [n.bucket for n in g.nodes], nb)
    enc_loads = bin_loads([v[0] for v in vectors],
                          [n.bucket for n in g.nodes], nb)
    ctx._diag["balance:main"] = {
        "bucket_loads": bb_loads, "imbalance": imbalance(bb_loads),
        "method": "multi_greedy", "level": "inter-module"}
    ctx._diag["balance:image"] = {
        "bucket_loads": enc_loads, "imbalance": imbalance(enc_loads),
        "method": "multi_greedy", "level": "inter-module"}
    if broadcast:
        ctx.broadcast_at(*broadcast)
    return ctx.plan(g)


STRATEGIES: dict[str, Callable] = {
    "vanilla": vanilla,
    "backbone_balance": backbone_balance,
    "hybrid_balance": hybrid_balance,
}
