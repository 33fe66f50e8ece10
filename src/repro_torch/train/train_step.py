"""Serve-step factories: the serving half of ``repro.train.train_step``.

The training half (loss, AdamW, ``make_train_step``) belongs to the next
slice of the port; see ROADMAP.md.
"""
from __future__ import annotations

import torch

from repro_torch.models.model_zoo import Model

COMPUTE_DTYPE = torch.bfloat16


def _cast_for_compute(model: Model) -> Model:
    """Cast every float32 leaf of rank > 1 to ``COMPUTE_DTYPE``, in place.

    The rule is JAX's, applied to the same stacked shapes: the per-layer
    norm scales (and RWKV6's ``u``, ``w0`` and ``mu_*``) are rank 2 or more
    because of the ``layers`` dim, so they become bf16 too, while
    ``final_norm`` (rank 1) stays float32.  JAX casts
    inside every jitted call; the port casts once, leaf by leaf, so the
    float32 tree is freed as it goes instead of a second full-size copy
    being made per call.  The cast is deterministic, so the numbers are
    the same.
    """
    for p in model.parameters():
        if p.dtype == torch.float32 and p.dim() > 1:
            p.data = p.data.to(COMPUTE_DTYPE)
    return model


def make_prefill_step(model: Model):
    """``prefill_step(batch) -> (logits, cache)`` on the bf16 weights."""
    _cast_for_compute(model)

    @torch.no_grad()
    def prefill_step(batch):
        return model.prefill(batch)
    return prefill_step


def make_decode_step(model: Model):
    """``decode_step(cache, tokens, pos) -> (logits, cache)`` on the bf16
    weights; the cache is updated in place."""
    _cast_for_compute(model)

    @torch.no_grad()
    def decode_step(cache, tokens, pos: int):
        return model.decode_step(cache, tokens, pos)
    return decode_step
