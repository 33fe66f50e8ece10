"""Plain PyTorch versions of the attention kernels (the allclose ground truth).

The port of ``repro.kernels.ref``: the same arithmetic, upcast to float32,
with the mask value -1e30 and the output in q's dtype.  ``kernels.ops``
sends CPU tensors here; on the card they are the kernels' yardstick for
correctness (not for speed).  ``wkv6_ref`` waits for its kernel's slice.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def packed_attention_ref(q, k, v, q_seg, kv_seg, *, causal: bool = True):
    """q: (b, h, sq, d); k, v: (b, kh, sk, d); segs: (b, s)."""
    b, h, sq, d = q.shape
    kh, sk = k.shape[1], k.shape[2]
    if kh != h:
        k = k.repeat_interleave(h // kh, dim=1)
        v = v.repeat_interleave(h // kh, dim=1)
    scale = d ** -0.5
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    mask = (q_seg[:, None, :, None] == kv_seg[:, None, None, :]) \
        & (kv_seg[:, None, None, :] > 0)
    if causal:
        sq_i = torch.arange(sq, device=q.device)[:, None]
        sk_i = torch.arange(sk, device=q.device)[None, :]
        mask = mask & (sq_i >= sk_i)[None, None]
    logits = torch.where(mask, logits, NEG_INF)
    m = torch.amax(logits, -1, keepdim=True)
    p = torch.where(mask, torch.exp(logits - m), 0.0)
    l = torch.sum(p, -1, keepdim=True)
    out = torch.einsum("bhqk,bhkd->bhqd", p / torch.clamp(l, min=1e-20),
                       v.float())
    out = torch.where((q_seg > 0)[:, None, :, None], out, 0.0)
    return out.to(q.dtype)


def flash_decode_ref(q, k_cache, v_cache, cache_len):
    """q: (b, h, d); caches: (b, kh, S, d); cache_len: (b,)."""
    b, h, d = q.shape
    kh, S = k_cache.shape[1], k_cache.shape[2]
    if kh != h:
        k_cache = k_cache.repeat_interleave(h // kh, dim=1)
        v_cache = v_cache.repeat_interleave(h // kh, dim=1)
    scale = d ** -0.5
    logits = torch.einsum("bhd,bhkd->bhk", q.float(), k_cache.float()) * scale
    mask = torch.arange(S, device=q.device)[None, None, :] \
        < cache_len[:, None, None]
    logits = torch.where(mask, logits, NEG_INF)
    m = torch.amax(logits, -1, keepdim=True)
    p = torch.where(mask, torch.exp(logits - m), 0.0)
    l = torch.sum(p, -1, keepdim=True)
    out = torch.einsum("bhk,bhkd->bhd", p / torch.clamp(l, min=1e-20),
                       v_cache.float())
    return out.to(q.dtype)
