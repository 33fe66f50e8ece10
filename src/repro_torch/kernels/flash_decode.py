"""Wrapper of the CUDA flash-decode kernel (``csrc/flash_decode.cu``).

Replaces the Pallas TPU kernel ``repro.kernels.flash_decode.flash_decode``:
one query token per sequence against a KV cache, positions >= cache_len
masked.  The wrapper takes CUDA tensors only and raises on anything the
kernel does not take; ``kernels.ops`` sends CPU tensors to ``kernels.ref``
instead.  ``launches`` counts the wrapper's calls that launched the kernel
(each call is a split pass plus a small combine pass).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

launches = 0

# Cache positions per block of the split pass.  At qwen3-8b serving shapes
# (batch 4, 8 kv heads, 544 positions) this gives 9 x 32 = 288 blocks.
SPLIT_LEN = 64

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_float


@functools.cache
def _kernel():
    lib = _build.load("flash_decode")
    fn = lib.flash_decode_launch
    fn.argtypes = [_P] * 8 + [_I] * 7 + [_L] * 10 + [_F, _I, _I, _P]
    fn.restype = _I
    return fn


def flash_decode(q: torch.Tensor, k_cache: torch.Tensor,
                 v_cache: torch.Tensor, cache_len: torch.Tensor
                 ) -> torch.Tensor:
    """q: (b, h, d); caches: (b, kh, S, d); cache_len: (b,) int32.

    q and the caches are float32 or bfloat16, independently; any strides
    with a unit last stride, so a layer's slice of the model cache
    (layers, b, S, kh, d) is read in place through ``permute``.  d <= 128.
    Returns (b, h, d) in q's dtype.
    """
    global launches
    tensors = (q, k_cache, v_cache, cache_len)
    if any(t.device.type != "cuda" or t.device != q.device for t in tensors):
        raise ValueError("flash_decode kernel: all inputs must be on one CUDA "
                         f"device; got {[str(t.device) for t in tensors]}")
    if q.dtype not in _DTYPES or k_cache.dtype not in _DTYPES \
            or v_cache.dtype != k_cache.dtype:
        raise ValueError("flash_decode kernel: q and the caches must be "
                         "float32 or bfloat16 (the two caches alike); got "
                         f"{q.dtype}, {k_cache.dtype}, {v_cache.dtype}")
    if q.dim() != 3 or k_cache.dim() != 4 or v_cache.shape != k_cache.shape:
        raise ValueError(f"bad shapes q {tuple(q.shape)} k_cache "
                         f"{tuple(k_cache.shape)} v_cache "
                         f"{tuple(v_cache.shape)}")
    b, h, d = q.shape
    kh, S = k_cache.shape[1], k_cache.shape[2]
    if k_cache.shape[0] != b or k_cache.shape[3] != d or h % kh != 0:
        raise ValueError(f"q {tuple(q.shape)} and cache "
                         f"{tuple(k_cache.shape)} do not match")
    if not 0 < d <= 128:
        raise ValueError(f"head_dim {d} not in (0, 128]")
    if q.stride(2) != 1 or k_cache.stride(3) != 1 or v_cache.stride(3) != 1:
        raise ValueError("q and the caches need a unit last stride")
    if cache_len.dtype != torch.int32 or cache_len.shape != (b,) \
            or not cache_len.is_contiguous():
        raise ValueError("cache_len must be contiguous int32 of shape "
                         f"{(b,)}; got {cache_len.dtype} "
                         f"{tuple(cache_len.shape)}")
    out = torch.empty((b, h, d), dtype=q.dtype, device=q.device)
    if b * h == 0 or S == 0:
        return out.zero_()
    n_split = -(-S // SPLIT_LEN)
    part_m = torch.empty((b, h, n_split), dtype=torch.float32,
                         device=q.device)
    part_l = torch.empty_like(part_m)
    part_acc = torch.empty((b, h, n_split, d), dtype=torch.float32,
                           device=q.device)
    with torch.cuda.device(q.device):
        err = _kernel()(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            cache_len.data_ptr(), out.data_ptr(), part_m.data_ptr(),
            part_l.data_ptr(), part_acc.data_ptr(), b, h, kh, S, d,
            SPLIT_LEN, n_split, *q.stride()[:2], *k_cache.stride()[:3],
            *v_cache.stride()[:3], *out.stride()[:2], d ** -0.5,
            _DTYPES[q.dtype], _DTYPES[k_cache.dtype],
            torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_decode kernel launch failed: CUDA error "
                           f"{err}")
    launches += 1
    return out
