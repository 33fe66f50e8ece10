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
made whole first, and the other arguments are placed to match.  So a KV
cache sharded over its sequence (``DECODE_RULES``' ``kv_seq``) is gathered
before ``decode_attention``; combining partial softmaxes across devices is
queued (ROADMAP.md).  The GQA keys and values, whose heads stay whole, are
cut on each rank to the heads its query shard uses.
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
from repro_torch.sharding.logical import dtensor_mesh, on_shards


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


def decode_attention(q, k_cache, v_cache, cache_len) -> torch.Tensor:
    """Layout: q (b, h, d); caches (b, kh, S, d); cache_len (b,)."""
    if dtensor_mesh(q) is not None:
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
