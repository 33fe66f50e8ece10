"""Attention: segment-aware (packed) attention and the KV-cache decode step.

The port of ``repro.models.attention``, in its layouts (b, s, h, d):
  * ``segment_attention``      — prefill/forward attention; goes through
                                 ``kernels.ops.packed_attention`` (the CUDA
                                 kernel on the card).
  * ``full_segment_attention`` — unchunked plain oracle (tests).
  * ``decode_attention``       — one-token step against a (possibly
                                 sequence-sharded) KV cache; goes through
                                 ``kernels.ops.decode_attention``.
  * ``write_position``         — a decode step's in-place write of its new
                                 k or v row into a cache, DTensor or not.

Packing semantics: segment id 0 marks padding; q attends to k iff
``seg_q == seg_k != 0`` and (causal) buffer index ``k <= q``.  GQA K/V are
passed to the kernels unexpanded, and as strided views, never copies.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops
from repro_torch.sharding.logical import dtensor_mesh

NEG_INF = -1e30


def expand_kv(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """(b, s, kh, d) -> (b, s, h, d) by repeating each kv head h/kh times."""
    kh = x.shape[2]
    if kh == num_heads:
        return x
    if num_heads % kh:
        raise ValueError(f"num_heads {num_heads} not a multiple of {kh}")
    return x.repeat_interleave(num_heads // kh, dim=2)


def full_segment_attention(q, k, v, q_seg, kv_seg, *, causal: bool = True):
    """Unchunked oracle.  q: (b,sq,h,d); k,v: (b,sk,h,d)."""
    sq, d = q.shape[1], q.shape[3]
    sk = k.shape[1]
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) \
        * d ** -0.5
    mask = (q_seg[:, None, :, None] == kv_seg[:, None, None, :]) \
        & (kv_seg[:, None, None, :] > 0)
    if causal:
        q_idx = torch.arange(sq, device=q.device)
        k_idx = torch.arange(sk, device=q.device)
        mask = mask & (q_idx[:, None] >= k_idx[None, :])[None, None]
    logits = torch.where(mask, logits, NEG_INF)
    m = torch.amax(logits, -1, keepdim=True)
    p = torch.where(mask, torch.exp(logits - m), 0.0)
    l = torch.sum(p, -1, keepdim=True)
    out = torch.einsum("bhqk,bkhd->bqhd", p / torch.clamp(l, min=1e-20),
                       v.float())
    valid = (q_seg > 0)[:, :, None, None]
    return torch.where(valid, out, 0.0).to(q.dtype)


def segment_attention(q, k, v, q_seg, kv_seg, *, causal: bool = True):
    """q: (b,sq,h,d); k,v: (b,sk,kh,d) with kh dividing h; segs (b,s) int32.

    Returns (b,sq,h,d) in q's dtype.  Inputs of two dtypes (a bf16 q on
    float32 keys, as Whisper's cross-attention meets them) run in the
    promoted dtype, as the JAX package's einsums promote.  The JAX
    package's kv-chunk knob has no counterpart: the kernel tiles the keys
    itself.
    """
    dt = torch.promote_types(torch.promote_types(q.dtype, k.dtype), v.dtype)
    out = ops.packed_attention(q.transpose(1, 2).to(dt),
                               k.transpose(1, 2).to(dt),
                               v.transpose(1, 2).to(dt), q_seg, kv_seg,
                               causal=causal)
    return out.transpose(1, 2).to(q.dtype)


def decode_attention(q, k_cache, v_cache, cache_len):
    """One-step decode.  q: (b,1,h,d); caches: (b,S,kh,d) (e.g. one layer's
    slice of the model cache); cache_len: (b,) int32 valid positions.

    Returns (b,1,h,d) in q's dtype; the softmax runs in float32 whatever
    the cache's dtype, as the JAX package's promoted einsum does.  On
    DTensor caches whose S is split (``DECODE_RULES``' or
    ``LONG_DECODE_RULES``' ``kv_seq``) the cache stays in place: each rank
    attends over its own positions and the partial softmaxes are merged by
    all-reduces, the KV-sequence-parallel decode of the reference
    (``kernels.ops``).
    """
    out = ops.decode_attention(q[:, 0], k_cache.transpose(1, 2),
                               v_cache.transpose(1, 2), cache_len)
    return out[:, None]


def write_position(cache, pos: int, row) -> None:
    """``cache[:, pos] = row`` in place, cast to the cache's dtype.  cache:
    (b, S, ...); row: (b, ...).  On a DTensor cache, whose ``S`` may be
    sharded (``DECODE_RULES``' ``kv_seq``), ``row`` is placed like the
    cache without ``S`` and the rank whose shard holds ``pos`` writes it
    into its local shard; the others write nothing."""
    mesh = dtensor_mesh(cache)
    if mesh is None:
        cache[:, pos] = row
        return
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset,
    )
    want = [Shard(p.dim - (p.dim > 1)) if p.is_shard() and p.dim != 1
            else Replicate() for p in cache.placements]
    if not isinstance(row, DTensor):
        row = DTensor.from_local(row, mesh, [Replicate()] * mesh.ndim,
                                 run_check=False)
    row = row.redistribute(mesh, want).to_local()
    shape, first = compute_local_shape_and_global_offset(
        cache.shape, mesh, cache.placements)
    if first[1] <= pos < first[1] + shape[1]:
        cache.to_local()[:, pos - first[1]] = row
