"""Plain PyTorch versions of the kernels (the allclose ground truth).

The port of ``repro.kernels.ref``: the same arithmetic, upcast to float32,
with the mask value -1e30 and the output in q's dtype.  ``kernels.ops``
sends CPU tensors here; on the card they are the kernels' yardstick for
correctness (not for speed).  Beside ``packed_attention_ref`` sit the
plain versions of what the training path adds: ``packed_attention_lse_ref``
(the forward kernel's log-sum-exp), ``packed_attention_bwd_ref`` (the
backward kernel) and ``packed_attention_bwd_bf16_ref`` (the same, rounding
where the kernel rounds), and ``packed_attention_live_tiles``, the tile
pairs the kernels' skip rule keeps; the tests and chip_smoke.py use them,
no model does.  ``flash_decode_ref(..., return_lse=True)`` is the plain
version of a cache shard's partial decode, which ``ops.merge_partials``
merges.  Two
plain versions of WKV6 sit here: the sequential oracle ``wkv6_ref`` and
``wkv6_chunked``, the port of the JAX model's chunked path
(``repro.models.rwkv.wkv6_chunked``), which ``models.rwkv`` re-exports
under its JAX name.  A third, ``wkv6_two_pass``,
repeats the CUDA kernel's decomposition for the tests and chip_smoke.py;
no model calls it.  Their gradients: ``wkv6_bwd_ref`` (autograd of
``wkv6_chunked``, the plain version of the ``wkv6_bwd`` kernel) and
``wkv6_bwd_two_pass`` (that kernel's decomposition).
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def _attention_mask(q_seg, kv_seg, sq: int, sk: int, causal: bool):
    """(b, 1, sq, sk): q attends to k iff seg_q == seg_k != 0 and, when
    causal, k <= q by buffer index."""
    mask = (q_seg[:, None, :, None] == kv_seg[:, None, None, :]) \
        & (kv_seg[:, None, None, :] > 0)
    if causal:
        sq_i = torch.arange(sq, device=q_seg.device)[:, None]
        sk_i = torch.arange(sk, device=q_seg.device)[None, :]
        mask = mask & (sq_i >= sk_i)[None, None]
    return mask


def _expand_kv(x, h: int):
    """(b, kh, s, d) -> (b, h, s, d), each kv head repeated h / kh times."""
    return x if x.shape[1] == h else x.repeat_interleave(h // x.shape[1],
                                                        dim=1)


def packed_attention_ref(q, k, v, q_seg, kv_seg, *, causal: bool = True):
    """q: (b, h, sq, d); k, v: (b, kh, sk, d); segs: (b, s)."""
    b, h, sq, d = q.shape
    sk = k.shape[2]
    k, v = _expand_kv(k, h), _expand_kv(v, h)
    scale = d ** -0.5
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    mask = _attention_mask(q_seg, kv_seg, sq, sk, causal)
    logits = torch.where(mask, logits, NEG_INF)
    m = torch.amax(logits, -1, keepdim=True)
    p = torch.where(mask, torch.exp(logits - m), 0.0)
    l = torch.sum(p, -1, keepdim=True)
    out = torch.einsum("bhqk,bhkd->bhqd", p / torch.clamp(l, min=1e-20),
                       v.float())
    out = torch.where((q_seg > 0)[:, None, :, None], out, 0.0)
    return out.to(q.dtype)


# The log-sum-exp of a row with no valid key (every padding row): exp(s -
# LSE_EMPTY) is 0 for every finite logit s, so such a row gets no gradient.
LSE_EMPTY = float("inf")


def packed_attention_lse_ref(q, k, q_seg, kv_seg, *, causal: bool = True):
    """The float32 (b, h, sq) log-sum-exp of each row's masked, scaled
    logits, which the forward kernel writes for the backward; LSE_EMPTY
    where a row has no valid key."""
    b, h, sq, d = q.shape
    sk = k.shape[2]
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(),
                          _expand_kv(k, h).float()) * d ** -0.5
    mask = _attention_mask(q_seg, kv_seg, sq, sk, causal)
    lse = torch.logsumexp(torch.where(mask, logits, NEG_INF), dim=-1)
    return torch.where(mask.any(-1), lse, LSE_EMPTY)


def packed_attention_bwd_ref(q, k, v, out, lse, dout, q_seg, kv_seg, *,
                             causal: bool = True):
    """dq, dk, dv of ``packed_attention_ref`` by the FlashAttention-2
    formulas, from the forward's output and log-sum-exp:
    D = rowsum(dout * out), P = exp(S scale - lse) on the mask,
    dV = P^T dO, dS = P * (dO V^T - D), dQ = dS K scale, dK = dS^T Q scale,
    dk and dv summed over each GQA group.  Arithmetic in float32; the
    gradients come back in the inputs' dtypes."""
    b, h, sq, d = q.shape
    kh, sk = k.shape[1], k.shape[2]
    scale = d ** -0.5
    qf, kf, vf = q.float(), _expand_kv(k, h).float(), _expand_kv(v, h).float()
    do = dout.float()
    mask = _attention_mask(q_seg, kv_seg, sq, sk, causal)
    s = torch.einsum("bhqd,bhkd->bhqk", qf, kf) * scale
    p = torch.where(mask, torch.exp(s - lse[..., None]), 0.0)
    delta = torch.sum(do * out.float(), -1)
    dv = torch.einsum("bhqk,bhqd->bhkd", p, do)
    dp = torch.einsum("bhqd,bhkd->bhqk", do, vf)
    ds = p * (dp - delta[..., None])
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kf) * scale
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, qf) * scale
    dk = dk.reshape(b, kh, h // kh, sk, d).sum(2)
    dv = dv.reshape(b, kh, h // kh, sk, d).sum(2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def packed_attention_bwd_bf16_ref(q, k, v, out, lse, dout, q_seg, kv_seg, *,
                                  causal: bool = True):
    """``packed_attention_bwd_ref`` with P and dS rounded to bfloat16 where
    the backward kernel rounds them, as the bf16 operands of its dV, dK and
    dQ products; sums in float32.  The yardstick of the kernel's arithmetic
    where the float32 oracles' elementwise tolerance is out of reach of any
    bf16 backward (long GQA groups, whose dK and dV sum many heads)."""
    b, h, sq, d = q.shape
    kh, sk = k.shape[1], k.shape[2]
    scale = d ** -0.5
    bf = torch.bfloat16
    qf, kf, vf = q.float(), _expand_kv(k, h).float(), _expand_kv(v, h).float()
    do = dout.float()
    mask = _attention_mask(q_seg, kv_seg, sq, sk, causal)
    s = torch.einsum("bhqd,bhkd->bhqk", qf, kf) * scale
    p = torch.where(mask, torch.exp(s - lse[..., None]), 0.0)
    delta = torch.sum(do * out.float(), -1)
    dv = torch.einsum("bhqk,bhqd->bhkd", p.to(bf).float(), do)
    dp = torch.einsum("bhqd,bhkd->bhqk", do, vf)
    ds = (p * (dp - delta[..., None])).to(bf).float()
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kf) * scale
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, qf) * scale
    dk = dk.reshape(b, kh, h // kh, sk, d).sum(2)
    dv = dv.reshape(b, kh, h // kh, sk, d).sum(2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def packed_attention_live_tiles(q_seg, kv_seg, *, causal: bool = True):
    """(b, n_qt, n_kt) bool: the (q tile, kv tile) pairs of 64 rows that
    the kernels compute, by the forward's skip rule
    (src/repro/kernels/packed_attention.py:55-63) as the backward kernel
    applies it: both tiles hold an id > 0, their id ranges (padding
    included, rows past the sequence left out) meet, and when causal the q
    tile's last row comes at or after the kv tile's first."""
    tile = 64

    def ranges(seg):
        b, s = seg.shape
        n = -(-s // tile)
        inside = (torch.arange(n * tile, device=seg.device) < s)[None]
        x = torch.nn.functional.pad(seg, (0, n * tile - s))
        big = torch.iinfo(seg.dtype).max
        lo = torch.where(inside, x, big).view(b, n, tile).amin(-1)
        hi = torch.where(inside, x, -big).view(b, n, tile).amax(-1)
        return lo, hi
    (qlo, qhi), (klo, khi) = ranges(q_seg), ranges(kv_seg)
    live = ((qhi[:, :, None] > 0) & (khi[:, None, :] > 0)
            & (qhi[:, :, None] >= klo[:, None, :])
            & (khi[:, None, :] >= qlo[:, :, None]))
    if causal:
        dev = q_seg.device
        q_last = torch.clamp(torch.arange(qlo.shape[1], device=dev) * tile
                             + tile, max=q_seg.shape[1]) - 1
        k_first = torch.arange(klo.shape[1], device=dev) * tile
        live = live & (q_last[:, None] >= k_first[None, :])[None]
    return live


def flash_decode_ref(q, k_cache, v_cache, cache_len, return_lse=False):
    """q: (b, h, d); caches: (b, kh, S, d); cache_len: (b,).  With
    ``return_lse``, the partial result of a shard of a cache split over
    its sequence, as the kernel gives it: (out (b, h, d), lse (b, h)),
    both float32, the lse in natural-log units and ``NEG_INF`` where no
    position is live (the output is 0 there)."""
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
    if return_lse:
        m, l = m[..., 0], l[..., 0]
        return out, torch.where(l > 0, m + torch.log(l), NEG_INF)
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


WKV6_SUB = 16       # tokens per sub-chunk of the intra-chunk products


def wkv6_two_pass(r, k, v, loga, u, reset, *, chunk: int,
                  sub: int = WKV6_SUB):
    """The CUDA ``wkv6`` kernel's decomposition, in plain PyTorch: the same
    function as ``wkv6_chunked``, at any s, ordered as the kernel orders it.

    Pass 1 walks the chunks and keeps the state entering each one.  Pass 2
    forms each chunk's outputs from its entering state alone.  Its pair
    weights A[t, s] (s < t, no reset in (s, t]) are built by sub-chunks of
    ``sub`` tokens: a diagonal block takes one exp per (t, s, i); a block
    below it (query sub-chunk T, key sub-chunk S < T) is the product of an
    r factor (the decay from T's first token to t) and a k factor (the
    decay from s to T's first token), with the reset mask applied after the
    product.  Every decay is taken over its own range: exp of a sum of
    loga (running sums within a sub-chunk, the totals of whole sub-chunks),
    clamped to <= 0, or, in the diagonal blocks and within a key's
    sub-chunk, a running product of the per-token decays exp(loga).  None
    is the difference of two cumsums, which in float32 loses about 6e-8
    |cw| (``wkv6_chunked`` does that, and at steep decays lands past 5e-5 /
    5e-4 of the exact answer).  Tokens past s, and the rows that pad a
    chunk to whole sub-chunks, read as zeros with no reset.

    r, k, v, loga: (b, s, h, dk) float32; u: (h, dk); reset: (b, s).
    Returns o (b, s, h, dk), the final state (b, h, dk, dv) and the states
    entering each chunk (b, h, nc, dk, dv).
    """
    F = torch.nn.functional
    b, s, h, dk = r.shape
    L = min(chunk, s)
    nc, nT = -(-s // L), -(-L // sub)
    Lp = nT * sub

    def chunks(a):  # (b, s, h, dk) -> (b, h, nc, Lp, dk), zero-padded
        a = F.pad(a, (0, 0, 0, 0, 0, nc * L - s)).reshape(b, nc, L, h, dk)
        return F.pad(a, (0, 0, 0, 0, 0, Lp - L)).permute(0, 3, 1, 2, 4)

    def excl(a, dim):  # running sum along ``dim`` of the entries before
        a = a.movedim(dim, -1)
        return F.pad(a, (1, 0))[..., :-1].cumsum(-1).movedim(-1, dim)

    def ex(a):
        return torch.exp(torch.clamp(a, max=0.0))

    rc, kc, vc, lac = map(chunks, (r, k, v, loga))
    flags = F.pad(reset.to(torch.int32), (0, nc * L - s)).reshape(b, nc, L)
    R = F.pad(flags, (0, Lp - L)).cumsum(-1)[:, None]      # (b, 1, nc, Lp)
    x = lac.reshape(b, h, nc, nT, sub, dk)
    lp = excl(x, 4)                    # decay over the sub-chunk before t
    ls = excl(x.flip(4), 4).flip(4)    # decay over the sub-chunk after s
    tot = x.sum(4)                                  # (b, h, nc, nT, dk)
    base = excl(tot, 3)                # the sub-chunks before T
    after = excl(tot.flip(3), 3).flip(3)            # the sub-chunks after

    # pass 1: S_{c+1} = dec_c S_c + k_hat_c^T v_c
    R_last = R[..., -1:]
    k_hat = kc * torch.where((R == R_last)[..., None],
                             ex(ls + after[..., None, :]).reshape(kc.shape),
                             0.0)
    dec = torch.where((R_last == 0)[..., None], ex(tot.sum(3))[..., None, :],
                      0.0)
    kv = torch.einsum("bhcsi,bhcsj->bhcij", k_hat, vc)
    S = torch.zeros((b, h, dk, dk), dtype=torch.float32, device=r.device)
    states = []
    for c in range(nc):
        states.append(S)
        S = dec[:, :, c, 0, :, None] * S + kv[:, :, c]
    states = torch.stack(states, 2)

    # pass 2: o = r_q S_c + A v + (r . (u * k)) v
    q = rc * torch.where((R == 0)[..., None],
                         ex(base[..., None, :] + lp).reshape(rc.shape), 0.0)
    o = torch.einsum("bhcti,bhcij->bhctj", q, states)
    rb, kb = rc.reshape(x.shape), kc.reshape(x.shape)
    d = ex(x)                                       # per-token decays

    def after_prod(a):  # product along the sub-chunk of the entries after
        return excl_prod(a.flip(-2)).flip(-2)

    def excl_prod(a):   # running product along dim -2 of the entries before
        return F.pad(a.movedim(-2, -1), (1, 0), value=1.0)[..., :-1] \
            .cumprod(-1).movedim(-1, -2)

    w = torch.zeros((b, h, nc, nT, sub, sub, dk), device=r.device)
    for t in range(1, sub):     # w[t, s] = product of d over (s, t)
        w[..., t, :t, :] = after_prod(d[..., :t, :])
    A_diag = torch.einsum("...ti,...si,...tsi->...ts", rb, kb, w)
    A = torch.zeros((b, h, nc, nT, sub, nT, sub), device=r.device)
    for T in range(nT):
        A[:, :, :, T, :, T, :] = A_diag[:, :, :, T]
        r_fac = rb[:, :, :, T] * ex(lp[:, :, :, T])
        for S_ in range(T):
            mid = torch.zeros_like(tot[:, :, :, 0])
            for U in range(S_ + 1, T):
                mid = mid + tot[:, :, :, U]
            k_fac = kb[:, :, :, S_] * (after_prod(d[:, :, :, S_])
                                       * ex(mid)[..., None, :])
            A[:, :, :, T, :, S_, :] = r_fac @ k_fac.transpose(-1, -2)
    A = A.reshape(b, h, nc, Lp, Lp)
    A = torch.where(R[..., :, None] == R[..., None, :], A, 0.0)
    bonus = torch.einsum("bhcti,hi,bhcti->bhct", rc, u, kc)
    o = o + A @ vc + bonus[..., None] * vc
    o = o[:, :, :, :L].permute(0, 2, 3, 1, 4).reshape(b, nc * L, h, dk)
    return o[:, :s], S, states


def wkv6_bwd_ref(r, k, v, loga, u, reset, dout, *, chunk: int):
    """The gradients of ``wkv6_chunked``'s output against ``dout``, by
    autograd in float32: the plain version of the ``wkv6_bwd`` kernel.
    A ragged s is padded to whole chunks with tokens that come after every
    real one (zeros, no gradient of their outputs), which changes no
    gradient of the real ones.  Returns dr, dk, dv, dloga (b, s, h, dk) and
    du (h, dk)."""
    F = torch.nn.functional
    s = r.shape[1]
    pad = -s % min(chunk, s)
    with torch.enable_grad():
        leaves = [t.detach().float().requires_grad_()
                  for t in (r, k, v, loga, u)]
        padded = [F.pad(t, (0, 0, 0, 0, 0, pad)) for t in leaves[:4]]
        o = wkv6_chunked(*padded, leaves[4], chunk=chunk,
                         reset=F.pad(reset, (0, pad)))
        return torch.autograd.grad(o[:, :s], leaves, dout.float())


def wkv6_bwd_two_pass(r, k, v, loga, u, reset, dout, *, chunk: int):
    """The CUDA ``wkv6_bwd`` kernel's decomposition, in plain PyTorch: the
    gradients of the WKV6 function (``wkv6_ref``, ``wkv6_chunked``) at any
    s, ordered as the kernel orders them.  Within a chunk, with entering
    state S, the state's gradient dS leaving the chunk, R the running reset
    count, and the masks of ``wkv6_chunked``:
        o_t  = r_q,t S + sum_{s<t} A[t,s] v_s + B_t v_t
        S'   = dec S + sum_s k_hat_s^T v_s
    r_q,t = r_t Pq_t (Pq_t: decay over [0, t), where R_t == 0);
    k_hat_s = k_s Pk_s (Pk_s: decay over (s, L), where R_s == R_last);
    dec = decay over [0, L) where R_last == 0;
    A[t,s] = sum_i r_t,i k_s,i W[t,s,i], W the decay over (s, t), where
    R_s == R_t; B_t = r_t . (u * k_t).

    Pass 1 walks the chunks backwards: dS leaving chunk c - 1 is
    dec_c dS_c + r_q,c^T dO_c.  Pass 2 forms each chunk's gradients from
    its entering state and the dS leaving it:
        dr_t = Pq_t (dO_t S^T) + sum_s dA[t,s] k_s W[t,s] + dB_t u k_t
        dk_s = Pk_s (v_s dS^T) + sum_t dA[t,s] r_t W[t,s] + dB_s u r_s
        dv_s = k_hat_s dS + sum_t A[t,s] dO_t + B_s dO_s
        du   = sum_t dB_t r_t k_t
    with dA[t,s] = dO_t . v_s on the pairs A keeps and dB_t = dO_t . v_t.
    loga_m sits in the exponent of every decay whose range holds m:
    Pq_t for t > m, Pk_s for s < m, dec, and W[t,s] for s < m < t.  With
    y = r (dr's first two terms), z = k (dk's second term) and w = k (dk's
    first term), the pairs that hold m are those of
    sum_{t>m} y_t - sum_{s>=m} z_s, so
        dloga_m = sum_{t>m} (y_t - z_t) - z_m + sum_{s<m} w_s
                  + dec (dS . S, summed over dv).

    The pair terms go by sub-chunks of WKV6_SUB tokens, the chunk padded to
    whole sub-chunks with tokens of decay 1 and zero inputs.  A diagonal
    block (query and key in one sub-chunk T) walks its pairs with W a
    running product of the per-token decays d = exp(loga), at most sub - 1
    deep.  A block below it (query sub-chunk T, key sub-chunk S < T)
    splits each decay at T's first token: with the factors
    q'_t = r_t qd_t (qd_t: the decay over [16 T, t)) and
    k'_s = k_s kd_s (kd_s: the decay over (s, 16 S + 16)), and mid the
    decay over the sub-chunks strictly between S and T,
        A_TS     = (q'_T mid) k'_S^T
        dr on T  = qd_T (sum_S mid (dA_TS k'_S))
        dk on S  = kd_S (sum_T mid (dA_TS^T q'_T))
        dv on S  = sum_T A_TS^T dO_T,
    the reset mask applied to A and dA after each product; the sums over S
    and T go in Horner form, a partial sum times one sub-chunk's decay
    before the next block's product is added.  Every decay is a product of
    d over its own range (within a sub-chunk, or of whole sub-chunks'
    products), never a difference of two float32 cumsums, which loses
    ~6e-8 |cw| and at steep decays moves results past 5e-5 / 5e-4.
    Returns dr, dk, dv, dloga (b, s, h, dk), du (h, dk), and the gradient
    of the state leaving each chunk (b, h, nc, dk, dv)."""
    F = torch.nn.functional
    b, s, h, dk = r.shape
    L = min(chunk, s)
    sub = WKV6_SUB
    nc, nT = -(-s // L), -(-L // sub)
    Lp = nT * sub

    def chunks(a):  # (b, s, h, dk) -> (b, h, nc, Lp, dk), zero-padded
        a = F.pad(a, (0, 0, 0, 0, 0, nc * L - s)).reshape(b, nc, L, h, dk)
        return F.pad(a, (0, 0, 0, 0, 0, Lp - L)).permute(0, 3, 1, 2, 4)

    def excl_prod(a, dim):   # running product of the entries before
        a = a.movedim(dim, -1)
        return F.pad(a, (1, 0), value=1.0)[..., :-1].cumprod(-1) \
            .movedim(-1, dim)

    def after_prod(a, dim):  # running product of the entries after
        return excl_prod(a.flip(dim), dim).flip(dim)

    rc, kc, vc, lac, oc = map(chunks, (r, k, v, loga, dout))
    flags = F.pad(reset.to(torch.int32), (0, nc * L - s)).reshape(b, nc, L)
    R = F.pad(flags, (0, Lp - L)).cumsum(-1)[:, None, :, :, None]
    q_ok, k_ok = R == 0, R == R[..., -1:, :]            # (b, 1, nc, Lp, 1)
    blocks = (b, h, nc, nT, sub, dk)
    d = torch.exp(torch.clamp(lac, max=0.0)).reshape(blocks)
    qd, kd = excl_prod(d, 4), after_prod(d, 4)          # within a sub-chunk
    tot = d.prod(4)                                     # (b, h, nc, nT, dk)
    base, after = excl_prod(tot, 3), after_prod(tot, 3)
    dec = torch.where(R[..., -1, :] == 0, tot.prod(3), 0.0)
    Pq = (base[..., None, :] * qd).reshape(rc.shape)
    Pk = (kd * after[..., None, :]).reshape(rc.shape)

    # the states entering each chunk, as the forward kernel keeps them
    S = wkv6_two_pass(r, k, v, loga, u, reset, chunk=chunk)[2]
    # pass 1: the gradient of the state leaving each chunk
    rq = rc * Pq * q_ok
    G = torch.zeros_like(S[:, :, 0])
    dstates = [None] * nc
    for c in reversed(range(nc)):
        dstates[c] = G
        G = dec[:, :, c, :, None] * G + rq[:, :, c].transpose(-1, -2) \
            @ oc[:, :, c]
    G = torch.stack(dstates, 2)

    # pass 2: the state's own terms, dA, and the diagonal blocks' walks
    pos = torch.arange(Lp, device=r.device)
    pair = (pos[:, None] > pos[None, :]) & (R == R.transpose(-1, -2))
    dr_state = (oc @ S.transpose(-1, -2)) * Pq * q_ok
    dA = (oc @ vc.transpose(-1, -2)) * pair
    dAb = dA.reshape(b, h, nc, nT, sub, nT, sub)
    rb, kb = rc.reshape(blocks), kc.reshape(blocks)
    W = torch.zeros((b, h, nc, nT, sub, sub, dk), device=r.device)
    for t in range(1, sub):     # W[t, s] = the product of d over (s, t)
        W[..., t, :t, :] = after_prod(d[..., :t, :], 4)
    dA_diag = torch.stack([dAb[:, :, :, T, :, T] for T in range(nT)], 3)
    A = torch.zeros((b, h, nc, nT, sub, nT, sub), device=r.device)
    for T in range(nT):
        A[:, :, :, T, :, T] = torch.einsum("...ti,...si,...tsi->...ts",
                                           rb[:, :, :, T], kb[:, :, :, T],
                                           W[:, :, :, T])
    dr_intra = torch.einsum("...ts,...si,...tsi->...ti", dA_diag, kb, W)
    dk_intra = torch.einsum("...ts,...ti,...tsi->...si", dA_diag, rb, W)

    # the blocks below the diagonal, as products of the factors
    qf, kf = rb * qd, kb * kd

    def mid(S_, T):  # the decay over the sub-chunks strictly between
        m = torch.ones_like(tot[:, :, :, 0])
        for U in range(S_ + 1, T):
            m = m * tot[:, :, :, U]
        return m[..., None, :]
    for T in range(1, nT):
        acc = torch.zeros_like(qf[:, :, :, T])
        for S_ in range(T):
            A[:, :, :, T, :, S_] = (qf[:, :, :, T] * mid(S_, T)) \
                @ kf[:, :, :, S_].transpose(-1, -2)
            if S_ > 0:
                acc = acc * tot[:, :, :, S_, None, :]
            acc = acc + dAb[:, :, :, T, :, S_] @ kf[:, :, :, S_]
        dr_intra[:, :, :, T] += qd[:, :, :, T] * acc
    for S_ in range(nT - 1):
        acc = torch.zeros_like(kf[:, :, :, S_])
        for T in reversed(range(S_ + 1, nT)):
            if T < nT - 1:
                acc = acc * tot[:, :, :, T, None, :]
            acc = acc + dAb[:, :, :, T, :, S_].transpose(-1, -2) \
                @ qf[:, :, :, T]
        dk_intra[:, :, :, S_] += kd[:, :, :, S_] * acc
    dr_intra, dk_intra = dr_intra.reshape(rc.shape), dk_intra.reshape(rc.shape)
    # A keeps the pairs with no reset between; the u bonus on its diagonal
    B = (rc * u[None, :, None, None] * kc).sum(-1)
    A = A.reshape(b, h, nc, Lp, Lp) * pair + torch.diag_embed(B)

    # the terms of the state leaving the chunk
    dB = (oc * vc).sum(-1, keepdim=True)
    k_hat = kf.reshape(rc.shape) * after.repeat_interleave(sub, 3) * k_ok
    Xk = vc @ G.transpose(-1, -2)
    uu = u[None, :, None, None]
    dr = dr_state + dr_intra + dB * uu * kc
    dkk = Pk * k_ok * Xk + dk_intra + dB * uu * rc
    dv = k_hat @ G + A.transpose(-1, -2) @ oc
    du = (dB * rc * kc).sum((0, 2, 3))
    y, z, w = rc * (dr_state + dr_intra), kc * dk_intra, k_hat * Xk
    after_yz = (y - z).flip(-2).cumsum(-2).flip(-2) - (y - z)
    before = w.cumsum(-2) - w
    ddec = (G * S).sum(-1)                              # (b, h, nc, dk)
    dloga = after_yz - z + before + (dec * ddec)[..., None, :]

    def unchunk(a):
        return a[:, :, :, :L].permute(0, 2, 3, 1, 4) \
            .reshape(b, nc * L, h, dk)[:, :s]
    return (*map(unchunk, (dr, dkk, dv, dloga)), du, G)
