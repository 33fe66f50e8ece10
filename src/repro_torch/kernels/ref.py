"""Plain PyTorch versions of the kernels (the allclose ground truth).

The port of ``repro.kernels.ref``: the same arithmetic, upcast to float32,
with the mask value -1e30 and the output in q's dtype.  ``kernels.ops``
sends CPU tensors here; on the card they are the kernels' yardstick for
correctness (not for speed).  Two plain versions of WKV6 sit here: the
sequential oracle ``wkv6_ref`` and ``wkv6_chunked``, the port of the JAX
model's chunked path (``repro.models.rwkv.wkv6_chunked``), which
``models.rwkv`` re-exports under its JAX name.
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


def wkv6_ref(r, k, v, loga, u, reset):
    """Sequential WKV6 oracle.  r, k, v, loga: (b, s, h, dk) float32;
    u: (h, dk); reset: (b, s) bool.  Returns (b, s, h, dk)."""
    b, s, h, dk = r.shape
    S = torch.zeros((b, h, dk, dk), dtype=torch.float32, device=r.device)
    outs = []
    for t in range(s):
        S = torch.where(reset[:, t, None, None, None], 0.0, S)
        kv = torch.einsum("bhi,bhj->bhij", k[:, t], v[:, t])
        outs.append(torch.einsum("bhi,bhij->bhj", r[:, t],
                                 S + u[None, :, :, None] * kv))
        S = S * torch.exp(loga[:, t])[..., None] + kv
    return torch.stack(outs, dim=1)


def wkv6_chunked(r, k, v, loga, u, *, chunk: int, reset,
                 return_state: bool = False):
    """Chunked WKV6, the JAX model's path.  r, k, v, loga: (b, s, h, dk)
    float32; u: (h, dk); reset: (b, s) bool, True where a segment starts
    (or on padding).  Returns o (b, s, h, dv) float32, and the final state
    S (b, h, dk, dv) if ``return_state``.

    Every exponent is a cumulative log-decay difference over a causal range,
    so <= 0.  Resets are tracked as counts, never folded into the decay
    cumsum (a -1e30 penalty in a float32 cumsum would destroy every later
    decay difference): a (t, s) interaction is valid iff the running reset
    count is equal at both ends.
    """
    b, s, h, dk = r.shape
    L = min(chunk, s)
    assert s % L == 0, (s, L)
    nc = s // L
    rst = reset.to(torch.int32)

    def split(a):  # (b, s, h, dk) -> (nc, b, h, L, dk)
        return a.reshape(b, nc, L, h, dk).permute(1, 0, 3, 2, 4)

    rc, kc, vc, lac = map(split, (r, k, v, loga))
    pc = rst.reshape(b, nc, L).transpose(0, 1)
    tri_strict = torch.tril(torch.ones((L, L), dtype=torch.bool,
                                       device=r.device), diagonal=-1)
    S = torch.zeros((b, h, dk, dk), dtype=torch.float32, device=r.device)
    outs = []
    for c in range(nc):
        rb, kb, vb, lab = rc[c], kc[c], vc[c], lac[c]    # (b, h, L, dk)
        cw = torch.cumsum(lab, dim=2)                     # incl current token
        cwm1 = cw - lab                                   # excl current token
        R = torch.cumsum(pc[c], dim=1)                    # resets up to t
        # state (inter-chunk) term: valid only if NO reset in chunk <= t
        q_valid = (R == 0)[:, None, :, None]
        q_exp = torch.where(q_valid, torch.exp(torch.clamp(cwm1, max=0.0)),
                            0.0)
        o = torch.einsum("bhti,bhij->bhtj", rb * q_exp, S)
        # intra: A[t,s] = sum_i r[t,i] k[s,i] exp(cwm1_t - cw_s), s < t,
        # valid iff no reset in (s, t]  <=>  R_t == R_s
        expo = cwm1[:, :, :, None] - cw[:, :, None]       # (b, h, t, s, i)
        pair_valid = (R[:, :, None] == R[:, None, :])[:, None, ..., None]
        ex = torch.where(pair_valid, torch.exp(torch.clamp(expo, max=0.0)),
                         0.0)
        A = torch.einsum("bhti,bhsi,bhtsi->bhts", rb, kb, ex)
        A = A * tri_strict
        o = o + torch.einsum("bhts,bhsj->bhtj", A, vb)
        # diagonal bonus term: (r_t . (u * k_t)) v_t
        diag = torch.einsum("bhti,hi,bhti->bht", rb, u, kb)
        o = o + diag[..., None] * vb
        # S' = exp(cw_L) S + sum_s exp(cw_L - cw_s) k_s^T v_s; the carried
        # state survives only a reset-free chunk, kv_s only if no reset in
        # (s, L]
        dec_all = torch.where((R[:, -1] == 0)[:, None, None],
                              torch.exp(torch.clamp(cw[:, :, -1], max=0.0)),
                              0.0)
        k_valid = (R[:, -1:] == R)[:, None, :, None]
        k_hat = kb * torch.where(
            k_valid, torch.exp(torch.clamp(cw[:, :, -1:] - cw, max=0.0)),
            0.0)
        S = S * dec_all[..., None] + torch.einsum("bhsi,bhsj->bhij", k_hat,
                                                  vb)
        outs.append(o)
    # nc x (b, h, L, dk) -> (b, s, h, dk)
    o = torch.stack(outs).permute(1, 0, 3, 2, 4).reshape(b, s, h, dk)
    if return_state:
        return o, S
    return o
