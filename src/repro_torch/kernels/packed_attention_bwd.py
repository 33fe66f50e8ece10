"""Wrapper of the CUDA packed-attention backward kernel
(``csrc/packed_attention_bwd.cu``).

The JAX package has no backward kernel: it differentiates the jnp
``segment_attention`` (``src/repro/models/attention.py:70``).  This kernel
is the gradient of the forward kernel (``kernels.packed_attention``), from
its output and the log-sum-exp it writes under ``return_lse``:
``dq, dk, dv`` by the FlashAttention-2 formulas, with dk and dv summed over
each GQA group.  One call is two kernel launches on the current stream
(dQ per q tile, which also writes D = rowsum(dO * O); then dK and dV per
kv tile), with no atomics, so the gradients are bitwise deterministic.
bfloat16 only, with ``d % 16 == 0``, ``d <= 128`` and sequences of at
most ``MAX_SEQ`` rows; anything else raises.  ``kernels.ops``
calls it from the autograd path; ``ref.packed_attention_bwd_ref`` is its
plain version, and ``ref.packed_attention_live_tiles`` the plain version
of the tile pairs it computes, which it reports under ``return_live``.
``launches`` counts calls.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.packed_attention import _aligned, _check_seg

launches = 0

MAX_SEQ = 65536   # 1024 tiles of 64 rows: the kernel's live-tile list
TILE = 64
# the C entry's answer, with no launch, when ptxas gave the kernels other
# register counts than their setmaxnreg split needs
_REGISTER_SPLIT = -1

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


@functools.cache
def _kernel():
    lib = _build.load("packed_attention_bwd")
    fn = lib.packed_attention_bwd_launch
    fn.argtypes = [_P, _P] + [_I] * 6 + [_F, _I, _P]
    fn.restype = _I
    return fn


def _aligned_bf16(t: torch.Tensor, name: str) -> torch.Tensor:
    """``t``, or a contiguous copy where its layout does not let the kernel
    move 16 bytes at a time or describe it to TMA (dO comes in whatever
    layout autograd gives, an expanded one included)."""
    if t.stride(-1) != 1 or not _aligned(t) or any(
            st == 0 and n > 1 for st, n in zip(t.stride(), t.shape)):
        t = t.contiguous()
    if not _aligned(t):
        raise ValueError(f"packed_attention_bwd kernel: {name} is not 16-byte "
                         "aligned")
    return t


def packed_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         out: torch.Tensor, lse: torch.Tensor,
                         dout: torch.Tensor, q_seg: torch.Tensor,
                         kv_seg: torch.Tensor, *, causal: bool = True,
                         return_live: bool = False):
    """q, out, dout: (b, h, sq, d); k, v: (b, kh, sk, d); lse: (b, h, sq)
    float32 (the forward's); segs: (b, sq) / (b, sk) int32.

    Returns (dq, dk, dv), bfloat16, laid out in memory like q, k and v.
    With ``return_live`` also the live 64-row tiles each CTA of the two
    launches found, as int32 counts: (b, h, q tiles) key tiles per dQ CTA,
    then (b, kh, key tiles) q tiles per dK/dV CTA (walked for each q head
    of its group).
    """
    global launches
    if any(t.dtype != torch.bfloat16 for t in (q, k, v, out, dout)):
        raise ValueError("packed_attention_bwd kernel: q, k, v, out and dout "
                         "must be bfloat16; got "
                         f"{[t.dtype for t in (q, k, v, out, dout)]}")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape \
            or out.shape != q.shape or dout.shape != q.shape:
        raise ValueError(f"bad shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)} out {tuple(out.shape)} dout "
                         f"{tuple(dout.shape)}")
    b, h, sq, d = q.shape
    kh, sk = k.shape[1], k.shape[2]
    if k.shape[0] != b or k.shape[3] != d or h % kh != 0:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} do not "
                         "match (batch, head_dim, or heads % kv_heads)")
    if d % 16 or not 0 < d <= 128:
        raise ValueError(f"head_dim {d} is not a multiple of 16 in "
                         "[16, 128]")
    if max(sq, sk) > MAX_SEQ:
        raise ValueError(f"sequences of {sq} and {sk} rows: the kernel takes "
                         f"at most {MAX_SEQ}")
    tensors = (q, k, v, out, lse, dout, q_seg, kv_seg)
    if any(t.device.type != "cuda" or t.device != q.device for t in tensors):
        raise ValueError("packed_attention_bwd kernel: all inputs must be on "
                         "one CUDA device; got "
                         f"{[str(t.device) for t in tensors]}")
    if lse.dtype != torch.float32 or lse.shape != (b, h, sq) \
            or not lse.is_contiguous():
        raise ValueError(f"lse must be contiguous float32 {(b, h, sq)}; got "
                         f"{lse.dtype} {tuple(lse.shape)}")
    _check_seg(q_seg, b, sq, "q_seg")
    _check_seg(kv_seg, b, sk, "kv_seg")
    q, k, v, out, dout = (_aligned_bf16(t, n) for t, n in zip(
        (q, k, v, out, dout), ("q", "k", "v", "out", "dout")))
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), \
        torch.empty_like(v)
    n_qt, n_kt = -(-sq // TILE), -(-sk // TILE)
    live = torch.zeros(b * h * n_qt + b * kh * n_kt, dtype=torch.int32,
                       device=q.device) if return_live else None
    if b * h * sq == 0 or sk == 0:
        grads = dq.zero_(), dk.zero_(), dv.zero_()
        return grads + _split_live(live, b, h, kh, n_qt, n_kt) \
            if return_live else grads
    delta = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    ptrs = (_P * 13)(*(t.data_ptr() for t in (
        q, k, v, out, dout, lse, delta, q_seg, kv_seg, dq, dk, dv)),
        None if live is None else live.data_ptr())
    strides = (ctypes.c_longlong * 26)(
        *(s for t in (q, k, v, out, dout, dq, dk, dv)
          for s in t.stride()[:3]), q_seg.stride(0), kv_seg.stride(0))
    with torch.cuda.device(q.device):
        err = _kernel()(ptrs, strides, b, h, kh, sq, sk, d, d ** -0.5,
                        int(causal),
                        torch.cuda.current_stream(q.device).cuda_stream)
    if err == _REGISTER_SPLIT:
        raise RuntimeError("packed_attention_bwd kernel: this build's "
                           "register counts do not fit the kernels' "
                           "setmaxnreg split (see stderr); not launched")
    if err != 0:
        raise RuntimeError(f"packed_attention_bwd kernel launch failed: CUDA "
                           f"error {err}")
    launches += 1
    if return_live:
        return dq, dk, dv, *_split_live(live, b, h, kh, n_qt, n_kt)
    return dq, dk, dv


def _split_live(live, b, h, kh, n_qt, n_kt):
    return (live[:b * h * n_qt].view(b, h, n_qt),
            live[b * h * n_qt:].view(b, kh, n_kt))
