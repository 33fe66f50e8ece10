"""Public kernel ops: the CUDA kernels on the card, plain versions on the CPU.

The port of ``repro.kernels.ops``.  The device of the inputs decides: CUDA
tensors go to the hand-written kernels (which launch or raise; nothing falls
back), CPU tensors go to ``kernels.ref`` because the caller put them there,
and so do meta tensors (the dry-run's, ``launch.dryrun``): they hold no
data, and the plain versions give their shapes and their FLOPs.  ``wkv6``
on meta runs the plain version as one custom op (``kernels.meta``), since
its chunk loop is too slow to trace at full size.
Under autograd, bfloat16 ``packed_attention`` on the card runs the forward
kernel (which then also writes each row's log-sum-exp) and the backward
kernel, and ``wkv6`` the forward kernel (which then also keeps the state
entering each chunk) and the backward kernel; float32 ``packed_attention``
and ``decode_attention`` have no backward and raise (ROADMAP.md).

DTensor arguments (a sharded step's) run the same op on each rank's local
shards through ``local_map``, so a shard of CUDA tensors runs the
hand-written kernel and a meta shard the plain version.  The first
argument's placements on the dims the kernel runs in parallel over (batch
and heads) are kept; any dim it reduces over (a sequence, a head dim) is
made whole first, and the other arguments are placed to match.  The GQA
keys and values, whose heads stay whole, are cut on each rank to the heads
its query shard uses.

The one exception is the KV-sequence-parallel decode of the reference
(``repro.models.attention.decode_attention`` under ``DECODE_RULES``' or
``LONG_DECODE_RULES``' ``kv_seq``): a KV cache split over its sequence
stays in place.  Each rank runs the kernel (or the plain version) on its
shard for a partial result, the float32 output and its log-sum-exp, and
``merge_partials`` merges the partials with all-reduces over the mesh dims
that split the sequence: a max of the lse, then one sum of the weighted
outputs with their weights beside them.  The all-reduces are functional
collectives inside the ``local_map``'d function, so ``CommDebugMode``
counts them and they run on meta shards in the dry-run's fake world; the
one function body also serves ``chip_smoke.py``, which merges pieces of a
cache stacked on one card with plain reductions.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import flash_decode as _flash_decode
from repro_torch.kernels import meta as _meta
from repro_torch.kernels import packed_attention as _packed_attention
from repro_torch.kernels import packed_attention_bwd as _packed_attention_bwd
from repro_torch.kernels import ref
from repro_torch.kernels import wkv6 as _wkv6
from repro_torch.kernels import wkv6_bwd as _wkv6_bwd
from repro_torch.sharding.logical import (
    dtensor_mesh, on_shards, seq_split_dims,
)


_PLAIN = ("cpu", "meta")     # devices whose tensors take the plain versions


def _kv_heads(kv, heads: int, first: int, local: int):
    """The heads (dim 1) of whole GQA keys or values that query heads
    ``[first, first + local)`` of ``heads`` read."""
    if local == heads:
        return kv
    group = heads // kv.shape[1]
    if local % group == 0:
        return kv[:, first // group:(first + local) // group]
    if group % local == 0:
        return kv[:, first // group:first // group + 1]
    raise ValueError(f"a shard of {local} of {heads} query heads spans a "
                     f"part of a GQA group of {group}")


_BH1 = {"b": 0, "h": 1}
_B = {"b": 0}


class _PackedAttention(torch.autograd.Function):
    """The forward kernel with its log-sum-exp, and the backward kernel."""

    @staticmethod
    def forward(ctx, q, k, v, q_seg, kv_seg, causal):
        out, lse = _packed_attention.packed_attention(
            q, k, v, q_seg, kv_seg, causal=causal, return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse, q_seg, kv_seg)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse, q_seg, kv_seg = ctx.saved_tensors
        dq, dk, dv = _packed_attention_bwd.packed_attention_bwd(
            q, k, v, out, lse, dout, q_seg, kv_seg, causal=ctx.causal)
        return dq, dk, dv, None, None, None


class _WKV6(torch.autograd.Function):
    """The forward kernel, keeping the state entering each chunk, and the
    backward kernel."""

    @staticmethod
    def forward(ctx, r, k, v, loga, u, reset, chunk):
        b, s, h, dk = r.shape
        nc = -(-s // min(chunk, s)) if s else 0
        states = torch.empty((b, h, nc, dk, dk), dtype=torch.float32,
                             device=r.device)
        out = _wkv6.wkv6(r, k, v, loga, u, reset, chunk=chunk,
                         chunk_states=states)
        ctx.save_for_backward(r, k, v, loga, u, reset, states)
        ctx.chunk = chunk
        return out

    @staticmethod
    def backward(ctx, dout):
        r, k, v, loga, u, reset, states = ctx.saved_tensors
        grads = _wkv6_bwd.wkv6_bwd(r, k, v, loga, u, reset,
                                   dout.contiguous(), states,
                                   chunk=ctx.chunk)
        return (*grads, None, None)


def packed_attention(q, k, v, q_seg, kv_seg, *, causal: bool = True
                     ) -> torch.Tensor:
    """Layout: q (b, h, sq, d); k/v (b, kh, sk, d); segs (b, s)."""
    if dtensor_mesh(q) is not None:
        def local(first, q, k, v, q_seg, kv_seg):
            k, v = (_kv_heads(t, heads, first[1], q.shape[1])
                    for t in (k, v))
            return packed_attention(q, k, v, q_seg, kv_seg, causal=causal)
        heads = q.shape[1]
        return on_shards(local, (q, k, v, q_seg, kv_seg),
                         (_BH1, _B, _B, _B, _B), (_BH1,), with_offset=True)
    if q.device.type in _PLAIN:
        return ref.packed_attention_ref(q, k, v, q_seg, kv_seg, causal=causal)
    if q.dtype == torch.bfloat16 and torch.is_grad_enabled() and any(
            t.requires_grad for t in (q, k, v)):
        return _PackedAttention.apply(q, k, v, q_seg, kv_seg, causal)
    # forward only; under grad the float32 kernel raises (it has no backward)
    return _packed_attention.packed_attention(q, k, v, q_seg, kv_seg,
                                              causal=causal)


def merge_partials(out, lse, reduce_max, reduce_sum, dtype
                   ) -> torch.Tensor:
    """The softmax over a whole cache from its pieces' partial results.

    ``out`` (..., d) and ``lse`` (...) float32 are one piece's (or a stack
    of pieces'), as ``flash_decode(..., return_lse=True)`` gives them;
    ``reduce_max`` and ``reduce_sum`` reduce a tensor over the pieces (an
    all-reduce over the mesh dims that split the sequence, or a reduction
    over a stacked dim kept as size 1).  The stable merge: M = max lse,
    w = exp(lse - M), out = sum w out / sum w, in float32, cast to
    ``dtype`` once.  A piece with no live position (lse ``NEG_INF``)
    weighs 0; where no piece has one, the output is 0, as the whole-cache
    softmax gives it."""
    w = torch.exp(lse - reduce_max(lse))[..., None]
    acc = reduce_sum(torch.cat([out * w, w], dim=-1))
    return (acc[..., :-1] / acc[..., -1:]).to(dtype)


def decode_partial(q, k_cache, v_cache, cache_len):
    """A cache shard's (out, lse), float32: the kernel on the card, the
    plain version on the CPU and on meta tensors."""
    if q.device.type in _PLAIN:
        return ref.flash_decode_ref(q, k_cache, v_cache, cache_len,
                                    return_lse=True)
    return _flash_decode.flash_decode(q, k_cache, v_cache, cache_len,
                                      return_lse=True)


def _all_reduce(t, op: str, groups):
    """``t`` all-reduced by ``op`` over each (mesh, dim) group in turn."""
    from torch.distributed import _functional_collectives as funcol
    for group in groups:
        t = funcol.wait_tensor(funcol.all_reduce(t, op, group))
    return t


def _seq_split_decode(q, k_cache, v_cache, cache_len, seq_dims):
    """``decode_attention`` on DTensor caches whose sequence (dim 2) is
    split over the mesh dims ``seq_dims``: each rank's partial on its own
    cache shard (its ``cache_len`` made local on the device: no host
    sync), merged over ``seq_dims``.  Batch and heads are placed as
    ``q``'s are, the rest as in the whole-cache path."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset,
    )
    mesh = k_cache.device_mesh
    by_dim = {d: r for r, d in _BH1.items()}
    mesh_roles = ["s" if i in seq_dims else
                  by_dim.get(p.dim) if p.is_shard() else None
                  for i, p in enumerate(q.placements)]
    kv_roles = {"b": 0, "s": 2}
    shape, first = compute_local_shape_and_global_offset(
        k_cache.shape, mesh, [Shard(kv_roles[r]) if r in kv_roles
                              else Replicate() for r in mesh_roles])
    groups = [(mesh, i) for i in seq_dims]
    heads = q.shape[1]

    def local(q_first, q, k_cache, v_cache, cache_len):
        k_cache, v_cache = (_kv_heads(t, heads, q_first[1], q.shape[1])
                            for t in (k_cache, v_cache))
        mine = (cache_len - first[2]).clamp(0, shape[2]).to(torch.int32)
        out, lse = decode_partial(q, k_cache, v_cache, mine)
        return merge_partials(
            out, lse, lambda t: _all_reduce(t, "max", groups),
            lambda t: _all_reduce(t, "sum", groups), q.dtype)
    return on_shards(local, (q, k_cache, v_cache, cache_len),
                     (_BH1, kv_roles, kv_roles, _B), (_BH1,), mesh_roles,
                     with_offset=True)


def decode_attention(q, k_cache, v_cache, cache_len) -> torch.Tensor:
    """Layout: q (b, h, d); caches (b, kh, S, d); cache_len (b,)."""
    if dtensor_mesh(q) is not None:
        seq_dims = seq_split_dims(k_cache)
        if seq_dims:
            return _seq_split_decode(q, k_cache, v_cache, cache_len,
                                     seq_dims)
        def local(first, q, k_cache, v_cache, cache_len):
            k_cache, v_cache = (_kv_heads(t, heads, first[1], q.shape[1])
                                for t in (k_cache, v_cache))
            return decode_attention(q, k_cache, v_cache, cache_len)
        heads = q.shape[1]
        return on_shards(local, (q, k_cache, v_cache, cache_len),
                         (_BH1, _B, _B, _B), (_BH1,), with_offset=True)
    if q.device.type in _PLAIN:
        return ref.flash_decode_ref(q, k_cache, v_cache, cache_len)
    return _flash_decode.flash_decode(q, k_cache, v_cache, cache_len)


def wkv6(r, k, v, loga, u, reset, *, chunk: int, return_state: bool = False):
    """Layout: r, k, v, loga (b, s, h, dk) float32; u (h, dk); reset (b, s).
    Returns o (b, s, h, dk) float32 (and the final state (b, h, dk, dk))."""
    if dtensor_mesh(r) is not None:
        bh = {"b": 0, "h": 2}
        return on_shards(
            lambda *xs: wkv6(*xs, chunk=chunk, return_state=return_state),
            (r, k, v, loga, u, reset), (bh, bh, bh, bh, {"h": 0}, _B),
            (bh, _BH1) if return_state else (bh,))
    if r.device.type == "cpu":
        return ref.wkv6_chunked(r, k, v, loga, u, chunk=chunk, reset=reset,
                                return_state=return_state)
    grad = torch.is_grad_enabled() and any(t.requires_grad
                                           for t in (r, k, v, loga, u))
    if grad and return_state:
        raise RuntimeError(
            "wkv6 under grad with return_state: the backward kernel "
            "takes no gradient of the final state, and no training path "
            "asks for it; see ROADMAP.md")
    if r.device.type == "meta":
        o, state = _meta.register()(r, k, v, loga, u, reset, chunk)
        return (o, state) if return_state else o
    if grad:
        return _WKV6.apply(r, k, v, loga, u, reset, chunk)
    return _wkv6.wkv6(r, k, v, loga, u, reset, chunk=chunk,
                      return_state=return_state)
