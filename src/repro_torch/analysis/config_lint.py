"""Config cross-validator (rule families CFG3xx and MDL4xx).

Checks an ``OverlordConfig`` (optionally against the trainer's
``ClientPlaceTree`` and the strategy registry) and ``ModelConfig`` model
definitions for inconsistencies that otherwise surface as hangs, silent
imbalance, or packing drops at train time: seq_len vs packing headroom
vs rows_per_microbatch, bucket count vs mesh/DP degree, prefetch vs
loader buffer depth, missing/unknown strategy params.
"""
from __future__ import annotations

import inspect
from typing import Optional

from repro_torch.analysis.findings import Report, Severity, make_report
from repro_torch.configs.base import ModelConfig
from repro_torch.core.orchestrator import OverlordConfig
from repro_torch.core.placetree import ClientPlaceTree
from repro_torch.core.resilience import validate_positive_policy
from repro_torch.core.strategies import STRATEGIES

# mean tokens/sample the orchestrator uses when auto-sizing a step
# (Overlord.start keeps the same constant)
EST_TOKENS_PER_SAMPLE = 96

_KNOWN_FAMILIES = {"dense", "moe", "hybrid", "vlm", "audio", "ssm"}
_KNOWN_DTYPES = {"bfloat16", "float32", "float16"}
_KNOWN_REMAT = {"none", "layer", "dots_saveable"}


# --------------------------------------------------------------- overlord
def lint_overlord_config(cfg: OverlordConfig,
                         tree: Optional[ClientPlaceTree] = None,
                         n_sources: Optional[int] = None,
                         strategies: Optional[dict] = None,
                         report: Optional[Report] = None) -> Report:
    rep = make_report(report)
    strategies = STRATEGIES if strategies is None else strategies
    where = "OverlordConfig"

    # CFG301 — dimensions that must be positive
    for field, minimum in (("seq_len", 1), ("rows_per_microbatch", 1),
                           ("n_bins", 1), ("buffer_target", 1),
                           ("vocab_size", 2)):
        v = getattr(cfg, field)
        if v < minimum:
            rep.add("CFG301", Severity.ERROR,
                    f"{field}={v} must be >= {minimum}", where,
                    "zero/negative sizes wedge packing and planning")
    if cfg.prefetch < 0 or cfg.samples_per_step < 0:
        rep.add("CFG301", Severity.ERROR,
                f"prefetch={cfg.prefetch} / samples_per_step="
                f"{cfg.samples_per_step} must be >= 0", where,
                "0 means 'auto' for samples_per_step, never negative")

    # CFG302 — packing headroom must be a usable fraction
    if not (0.0 < cfg.fill_factor <= 1.0):
        rep.add("CFG302", Severity.ERROR,
                f"fill_factor={cfg.fill_factor} outside (0, 1]", where,
                "fill_factor is the packed-row occupancy target; "
                "1.0 packs to the brim, <=0 selects no samples")

    # CFG303 — strategy must exist
    if cfg.strategy not in strategies:
        rep.add("CFG303", Severity.ERROR,
                f"unknown strategy {cfg.strategy!r}", where,
                f"known strategies: {sorted(strategies)}")
    else:
        _lint_strategy_params(cfg, strategies[cfg.strategy], rep, where)

    # CFG308 — differential checkpoint frequencies
    if cfg.planner_ckpt_every < 1 or cfg.loader_ckpt_every < 1:
        rep.add("CFG308", Severity.ERROR,
                f"checkpoint frequencies must be >= 1 (planner="
                f"{cfg.planner_ckpt_every}, loader="
                f"{cfg.loader_ckpt_every})", where,
                "a frequency of 0 disables the replay window the "
                "recovery path depends on")
    elif cfg.loader_ckpt_every < cfg.planner_ckpt_every:
        rep.add("CFG308", Severity.WARNING,
                f"loader_ckpt_every={cfg.loader_ckpt_every} < "
                f"planner_ckpt_every={cfg.planner_ckpt_every} inverts "
                "differential checkpointing", where,
                "loaders carry the heavy buffers; checkpoint them less "
                "often than the planner and cover the gap with replay")

    # CFG309 — resilience knobs (retry / breaker / DLQ)
    if not validate_positive_policy(cfg.retry):
        rep.add("CFG309", Severity.ERROR,
                f"retry policy is degenerate (max_attempts="
                f"{cfg.retry.max_attempts}, base_delay_s="
                f"{cfg.retry.base_delay_s}, max_delay_s="
                f"{cfg.retry.max_delay_s}, multiplier="
                f"{cfg.retry.multiplier}, jitter={cfg.retry.jitter})",
                where,
                "a policy needs >= 1 attempt, non-negative delays with "
                "base <= max, multiplier >= 1 and jitter in [0, 1]")
    if cfg.breaker_failures < 1:
        rep.add("CFG309", Severity.ERROR,
                f"breaker_failures={cfg.breaker_failures} must be >= 1",
                where,
                "the circuit breaker opens after this many consecutive "
                "read failures; < 1 would open on a healthy source")
    if cfg.breaker_cooldown_s < 0:
        rep.add("CFG309", Severity.ERROR,
                f"breaker_cooldown_s={cfg.breaker_cooldown_s} must be "
                ">= 0", where,
                "the cooldown gates the half-open probe")
    if cfg.dlq_capacity < 1:
        rep.add("CFG309", Severity.ERROR,
                f"dlq_capacity={cfg.dlq_capacity} must be >= 1", where,
                "corrupted samples are quarantined here instead of "
                "killing the loader; the queue needs room for at least "
                "one entry")

    # CFG310 — pipelined planning knobs
    if cfg.plan_ahead < 0:
        rep.add("CFG310", Severity.ERROR,
                f"plan_ahead={cfg.plan_ahead} must be >= 0", where,
                "plan_ahead is the background planning lookahead window; "
                "0 disables pipelining, negative values are meaningless")
    elif cfg.plan_ahead > 0 and cfg.prefetch == 0:
        rep.add("CFG310", Severity.WARNING,
                f"plan_ahead={cfg.plan_ahead} with prefetch=0", where,
                "the lookahead only hides planner latency when clients "
                "prefetch; enable client prefetch to benefit from "
                "pipelined planning")

    # CFG311 — durable job-recovery knobs (manifest cadence / retention)
    if cfg.manifest_every < 1 or cfg.keep_epochs < 1:
        rep.add("CFG311", Severity.ERROR,
                f"manifest_every={cfg.manifest_every} / keep_epochs="
                f"{cfg.keep_epochs} must be >= 1", where,
                "manifest_every paces the atomic epoch commit point and "
                "keep_epochs is the corruption-fallback depth; < 1 "
                "leaves the job without a resumable epoch")
    elif cfg.checkpoint_dir \
            and cfg.loader_ckpt_every % max(cfg.manifest_every, 1) != 0:
        rep.add("CFG311", Severity.WARNING,
                f"manifest_every={cfg.manifest_every} does not divide "
                f"loader_ckpt_every={cfg.loader_ckpt_every}", where,
                "actor cuts land only on steps divisible by BOTH "
                "cadences; misaligned cadences stretch the replay "
                "window a resume must cover")

    # tree-dependent rules
    if tree is not None:
        _lint_against_tree(cfg, tree, n_sources, rep, where)
    return rep


def _lint_strategy_params(cfg: OverlordConfig, fn, rep: Report,
                          where: str):
    """CFG304 — strategy_params must satisfy the strategy signature."""
    try:
        sig = inspect.signature(fn)
    except (TypeError, ValueError):
        return
    supplied = set(cfg.strategy_params) | {"schedule", "total", "n_bins"}
    for p in list(sig.parameters.values())[1:]:
        if p.kind == inspect.Parameter.VAR_KEYWORD:
            return  # **params swallows anything; nothing to check
        if p.default is inspect.Parameter.empty and p.name not in supplied:
            rep.add("CFG304", Severity.ERROR,
                    f"strategy {cfg.strategy!r} requires parameter "
                    f"{p.name!r} but strategy_params does not provide it",
                    where,
                    f"add {p.name!r} to OverlordConfig.strategy_params")
    valid = set(sig.parameters) - {"ctx"}
    for key in cfg.strategy_params:
        if key not in valid:
            rep.add("CFG304", Severity.ERROR,
                    f"strategy_params key {key!r} is not accepted by "
                    f"strategy {cfg.strategy!r}", where,
                    f"accepted params: {sorted(valid)}")


def _lint_against_tree(cfg: OverlordConfig, tree: ClientPlaceTree,
                       n_sources: Optional[int], rep: Report, where: str):
    axis = cfg.strategy_params.get("axis", "DP")

    # CFG305 — distribute/broadcast axes must exist in the mesh tree
    known = set(tree.names) | {"WORLD"}
    if axis not in known:
        rep.add("CFG305", Severity.ERROR,
                f"distribute axis {axis!r} not in the client tree "
                f"(axes: {tree.names})", where,
                "constructors are created per bucket at this axis; an "
                "unknown axis raises inside Overlord.start()")
        return
    for b in cfg.strategy_params.get("broadcast", ()) or ():
        if b not in known:
            rep.add("CFG305", Severity.ERROR,
                    f"broadcast axis {b!r} not in the client tree "
                    f"(axes: {tree.names})", where,
                    "broadcast_at() with an unknown axis raises at the "
                    "first plan")

    # CFG306 — step sizing vs packing capacity (bucket count vs DP degree)
    nb = tree.buckets(axis)
    capacity_tokens = nb * cfg.n_bins * cfg.rows_per_microbatch \
        * cfg.seq_len
    sps = cfg.samples_per_step or max(
        nb * cfg.n_bins,
        int(capacity_tokens * cfg.fill_factor / EST_TOKENS_PER_SAMPLE))
    if sps < nb * cfg.n_bins:
        rep.add("CFG306", Severity.ERROR,
                f"samples_per_step={sps} cannot populate "
                f"{nb} bucket(s) x {cfg.n_bins} bin(s)", where,
                "every microbatch bin needs at least one sample or the "
                "train step receives an empty packed batch")
    elif sps * EST_TOKENS_PER_SAMPLE > capacity_tokens:
        rep.add("CFG306", Severity.WARNING,
                f"samples_per_step={sps} (~{sps * EST_TOKENS_PER_SAMPLE} "
                f"tokens) exceeds packing capacity {capacity_tokens} "
                f"tokens ({nb} buckets x {cfg.n_bins} bins x "
                f"{cfg.rows_per_microbatch} rows x {cfg.seq_len})", where,
                "overflow samples are silently dropped by the packer; "
                "lower samples_per_step or raise rows_per_microbatch")

    # CFG307 — prefetch pressure vs loader buffer depth
    if n_sources:
        per_source_demand = -(-sps // n_sources)  # ceil
        if cfg.buffer_target < per_source_demand:
            rep.add("CFG307", Severity.WARNING,
                    f"buffer_target={cfg.buffer_target} < ~"
                    f"{per_source_demand} samples a single step draws "
                    f"per source ({n_sources} sources, prefetch="
                    f"{cfg.prefetch})", where,
                    "a skewed mix() can drain a loader buffer mid-step "
                    "and stall prefetch; raise buffer_target")


# ------------------------------------------------------------------ model
def lint_model_config(cfg: ModelConfig,
                      report: Optional[Report] = None) -> Report:
    rep = make_report(report)
    where = f"ModelConfig:{cfg.name}"

    # MDL401 — attention head geometry
    if cfg.num_heads < 1 or cfg.num_layers < 1 or cfg.d_model < 1:
        rep.add("MDL401", Severity.ERROR,
                f"non-positive core dims (layers={cfg.num_layers}, "
                f"d_model={cfg.d_model}, heads={cfg.num_heads})", where,
                "")
        return rep
    if cfg.head_dim == 0 and cfg.d_model % cfg.num_heads != 0:
        rep.add("MDL401", Severity.ERROR,
                f"d_model={cfg.d_model} not divisible by num_heads="
                f"{cfg.num_heads} and no explicit head_dim", where,
                "set head_dim explicitly when q_dim != d_model")

    # MDL402 — GQA grouping
    if cfg.num_kv_heads < 1 or cfg.num_heads % cfg.num_kv_heads != 0:
        rep.add("MDL402", Severity.ERROR,
                f"num_kv_heads={cfg.num_kv_heads} must divide "
                f"num_heads={cfg.num_heads}", where,
                "GQA repeats each kv head num_heads/num_kv_heads times")

    # MDL403 — MoE routing
    if cfg.num_experts > 0:
        if not (0 < cfg.experts_per_token <= cfg.num_experts):
            rep.add("MDL403", Severity.ERROR,
                    f"experts_per_token={cfg.experts_per_token} outside "
                    f"(0, num_experts={cfg.num_experts}]", where,
                    "top-k routing needs 1 <= k <= E")
        if cfg.capacity_factor <= 0:
            rep.add("MDL403", Severity.ERROR,
                    f"capacity_factor={cfg.capacity_factor} must be > 0",
                    where, "")
    elif cfg.experts_per_token > 0:
        rep.add("MDL403", Severity.ERROR,
                f"experts_per_token={cfg.experts_per_token} set but "
                "num_experts=0", where,
                "either declare the expert pool or drop the router")

    # MDL404 — family-specific input expectations
    if cfg.family not in _KNOWN_FAMILIES:
        rep.add("MDL404", Severity.ERROR,
                f"unknown family {cfg.family!r}", where,
                f"known families: {sorted(_KNOWN_FAMILIES)}")
    if cfg.family == "vlm" and cfg.image_token_frac <= 0:
        rep.add("MDL404", Severity.WARNING,
                "vlm config with image_token_frac=0 never sees image "
                "embeds", where, "set image_token_frac > 0")
    if cfg.family == "audio" and cfg.encoder_layers <= 0:
        rep.add("MDL404", Severity.WARNING,
                "audio config without encoder layers", where,
                "set encoder_layers > 0")

    # MDL405 — vocab / numerics enums
    if cfg.vocab_size < 2:
        rep.add("MDL405", Severity.ERROR,
                f"vocab_size={cfg.vocab_size} must be >= 2", where, "")
    if cfg.dtype not in _KNOWN_DTYPES:
        rep.add("MDL405", Severity.ERROR,
                f"unknown dtype {cfg.dtype!r}", where,
                f"known: {sorted(_KNOWN_DTYPES)}")
    if cfg.remat not in _KNOWN_REMAT:
        rep.add("MDL405", Severity.ERROR,
                f"unknown remat policy {cfg.remat!r}", where,
                f"known: {sorted(_KNOWN_REMAT)}")
    return rep


def lint_shipped_model_configs(report: Optional[Report] = None) -> Report:
    """Validate every registered config in repro.configs."""
    from repro_torch.configs import get_config, list_configs
    rep = make_report(report)
    for name in list_configs():
        lint_model_config(get_config(name), rep)
    return rep
