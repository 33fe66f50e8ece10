"""The JAX package's rematerialisation policy, ``cfg.remat``, for the
training forward.

``jax.checkpoint`` around a layer becomes ``torch.utils.checkpoint`` with
``use_reentrant=False``: the forward keeps only the layer's inputs, and the
backward runs the layer again, the kernels it calls included, before it
differentiates it.  The policies are the JAX package's:

- ``"none"``: no checkpoint; autograd keeps every activation;
- ``"layer"``: keep nothing of the layer (``jax.checkpoint``'s default);
- ``"dots_saveable"``: keep the outputs of the matrix products and recompute
  the rest.  A ``dot_general`` in JAX is an ``aten.mm``, ``aten.addmm`` or
  ``aten.bmm`` here.  Every other op is recomputed, ``torch.empty``
  included, so the buffers the CUDA kernels' wrappers allocate and write
  into are made anew in the recompute and never handed back from a cache.

The wrap applies only while grad is enabled, so ``prefill``, ``decode_step``
and serving run each layer once, as they do without it.  No layer draws
random numbers, so the recompute needs no saved RNG state.
"""
from __future__ import annotations

import functools

import torch
from torch.utils.checkpoint import (
    CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts,
)

from repro_torch.sharding.logical import current_rules, rules_in, sharded

POLICIES = ("none", "layer", "dots_saveable")

_DOTS = frozenset((torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
                   torch.ops.aten.bmm.default))


def _save_dots(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _dots_saveable_contexts():
    return create_selective_checkpoint_contexts(_save_dots)


def whole_layer(policy: str) -> str:
    """The policy of a model whose reference checkpoints whole layers for
    any value but ``"none"`` (rwkv6, the hybrid, Whisper)."""
    return "none" if policy == "none" else "layer"


def remat(fn, policy: str):
    """``fn`` under ``policy`` (one of ``POLICIES``) while grad is
    enabled; ``fn`` itself otherwise."""
    if policy not in POLICIES:
        raise ValueError(f"unknown remat policy {policy!r}; known: "
                         f"{POLICIES}")
    if policy == "none":
        return fn
    kw = dict(use_reentrant=False, preserve_rng_state=False)
    if policy == "dots_saveable":
        kw["context_fn"] = _dots_saveable_contexts

    @functools.wraps(fn)
    def run(*args):
        if not torch.is_grad_enabled():
            return fn(*args)
        rules = current_rules()

        def body(*args):
            # the recompute runs on autograd's thread, outside the caller's
            # context: the sharding rules and a sharded step's context are
            # entered again there
            with rules_in(rules), sharded(args):
                return fn(*args)
        return checkpoint(body, *args, **kw)
    return run
