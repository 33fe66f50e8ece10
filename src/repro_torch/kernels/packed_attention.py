"""Wrapper of the CUDA packed-attention kernel (``csrc/packed_attention.cu``).

Replaces the Pallas TPU kernel ``repro.kernels.packed_attention.
packed_flash_attention``: segment-aware causal flash attention, forward.
bfloat16 inputs run on the tensor cores (``mma.sync``), float32 inputs on
the CUDA cores, behind one C entry point.  With ``return_lse`` the kernel
also writes each row's log-sum-exp, which the backward kernel
(``kernels.packed_attention_bwd``) reads; ``kernels.ops`` wires the two
into autograd.  Called directly, the wrapper refuses inputs that require
grad: its output would carry none.
The wrapper takes CUDA tensors only and raises on anything the kernel does
not take; ``kernels.ops`` sends CPU tensors to ``kernels.ref`` instead.
``launches`` counts the wrapper's kernel launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch import kernels
from repro_torch.kernels import _build

launches = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_float


@functools.cache
def _kernel():
    lib = _build.load("packed_attention")
    fn = lib.packed_attention_launch
    fn.argtypes = ([_P] * 7 + [_I] * 6 + [_L] * 14 + [_F, _I, _I, _I, _P])
    fn.restype = _I
    return fn


def _aligned(t: torch.Tensor) -> bool:
    """The pointer and the batch, head and row strides are whole multiples
    of 16 bytes, so the bfloat16 kernel can move 16 bytes at a time."""
    es = t.element_size()
    return t.data_ptr() % 16 == 0 and all(
        s * es % 16 == 0 for s in t.stride()[:3])


def _check_seg(seg: torch.Tensor, b: int, s: int, name: str):
    if seg.dtype != torch.int32 or seg.shape != (b, s) or seg.stride(1) != 1:
        raise ValueError(f"{name} must be int32 of shape {(b, s)} with a unit "
                         f"last stride; got {seg.dtype} {tuple(seg.shape)} "
                         f"strides {seg.stride()}")


def packed_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     q_seg: torch.Tensor, kv_seg: torch.Tensor, *,
                     causal: bool = True, return_lse: bool = False):
    """q: (b, h, sq, d); k, v: (b, kh, sk, d); segs: (b, sq) / (b, sk) int32.

    Any strides with a unit last stride (e.g. ``x.transpose(1, 2)`` views of
    (b, s, h, d) activations).  float32 or bfloat16, d <= 128.  Returns
    (b, h, sq, d) in q's dtype, laid out in memory like q; with
    ``return_lse`` (bfloat16 only: float32 has no backward to read it) also
    the (b, h, sq) float32 log-sum-exp of each row's masked, scaled logits
    (``ref.LSE_EMPTY`` where a row has no valid key).
    """
    global launches
    kernels.refuse_grad("packed_attention", (q, k, v),
                " here (bfloat16 trains through kernels.ops.packed_attention "
                "and the backward kernel; float32 has none)")
    if return_lse and q.dtype != torch.bfloat16:
        raise ValueError("packed_attention kernel: return_lse takes bfloat16 "
                         f"inputs only; got {q.dtype}")
    tensors = (q, k, v, q_seg, kv_seg)
    if any(t.device.type != "cuda" or t.device != q.device for t in tensors):
        raise ValueError("packed_attention kernel: all inputs must be on one "
                         f"CUDA device; got {[str(t.device) for t in tensors]}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError("packed_attention kernel: q, k, v must share dtype "
                         f"float32 or bfloat16; got {q.dtype}, {k.dtype}, "
                         f"{v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"bad shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}")
    b, h, sq, d = q.shape
    kh, sk = k.shape[1], k.shape[2]
    if k.shape[0] != b or k.shape[3] != d or h % kh != 0:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} do not "
                         "match (batch, head_dim, or heads % kv_heads)")
    if not 0 < d <= 128:
        raise ValueError(f"head_dim {d} not in (0, 128]")
    if q.stride(3) != 1 or k.stride(3) != 1 or v.stride(3) != 1:
        raise ValueError("q, k, v need a unit last stride")
    _check_seg(q_seg, b, sq, "q_seg")
    _check_seg(kv_seg, b, sk, "kv_seg")
    # keeps q's layout where q is dense (a (b, s, h, d) buffer seen as
    # (b, h, s, d)), so the caller's transpose back is free; else contiguous
    out = torch.empty_like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device) \
        if return_lse else None
    if b * sq * h == 0 or sk == 0:
        if return_lse:
            return out.zero_(), lse.fill_(float("inf"))
        return out.zero_()
    vec = d % 8 == 0 and all(_aligned(t) for t in (q, k, v, out))
    with torch.cuda.device(q.device):
        err = _kernel()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), q_seg.data_ptr(),
            kv_seg.data_ptr(), out.data_ptr(),
            lse.data_ptr() if return_lse else None, b, h, kh, sq, sk, d,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *out.stride()[:3], q_seg.stride(0), kv_seg.stride(0), d ** -0.5,
            int(causal), _DTYPES[q.dtype], int(vec),
            torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"packed_attention kernel launch failed: CUDA "
                           f"error {err}")
    launches += 1
    return (out, lse) if return_lse else out
