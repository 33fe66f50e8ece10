"""Wrapper of the CUDA flash-decode kernel (``csrc/flash_decode.cu``).

Replaces the Pallas TPU kernel ``repro.kernels.flash_decode.flash_decode``:
one query token per sequence against a KV cache, positions >= cache_len
masked.  The wrapper takes CUDA tensors only and raises on anything the
kernel does not take; ``kernels.ops`` sends CPU tensors to ``kernels.ref``
instead.  ``launches`` counts the wrapper's calls that launched the kernel;
a call is one kernel launch (the combine of the split partials is fused).
With ``return_lse`` a call gives a shard's partial result, the float32
output and its log-sum-exp, which ``ops.merge_partials`` merges across the
shards of a cache split over its sequence.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch import kernels
from repro_torch.kernels import _build

launches = 0

# WARPS, TILE_ROWS (TP) and DMAX are the kernel's constants
WARPS = 4        # warps per CTA
TILE_ROWS = 8    # cache rows per warp tile
DMAX = 128       # largest head dim
# CTAs per SM the split plan allows: the kernel's launch bounds and a
# two-stage float32 ring (64 KB of shared memory a CTA) both allow three
RESIDENT = 3

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_float
# the kernel's mask value, and the lse of a shard with no live position
NEG_INF = -1e30
_scratch: dict = {}


class SplitPlan(NamedTuple):
    """How the kernel's grid cuts the work of one call.

    ``heads`` q heads of a GQA group share a CTA (``n_gchunks`` CTAs cover
    the group); CTA ``split`` reads cache positions ``split * split_len``
    up to ``split_len`` more; within it warp ``w`` takes the tiles of
    ``TILE_ROWS`` rows that start at ``w * TILE_ROWS`` plus multiples of
    ``WARPS * TILE_ROWS``.  ``stages`` is the depth of each warp's K/V ring:
    2 where a warp has more than one tile, so the next is in flight while
    this one is computed.
    """
    heads: int
    n_gchunks: int
    split_len: int
    n_split: int
    stages: int


def split_plan(b: int, kh: int, group: int, S: int, sm_count: int
               ) -> SplitPlan:
    """The fewest positions per CTA (a multiple of ``WARPS * TILE_ROWS``)
    that keep the grid within ``RESIDENT`` CTAs per SM, so it runs in one
    wave: a second wave would add a whole CTA's latency.  The plan
    is from the cache's capacity S: cache_len lives on the device, and
    reading it would stall the host (and break CUDA-graph capture); CTAs
    past cache_len[b] read nothing."""
    heads = next(g for g in (1, 2, 4, 8) if g >= min(group, 8))
    n_gchunks = -(-group // heads)
    rows = WARPS * TILE_ROWS
    want = max(1, RESIDENT * sm_count // (b * kh * n_gchunks))
    split_len = -(-(-(-S // want)) // rows) * rows
    return SplitPlan(heads, n_gchunks, split_len, -(-S // split_len),
                     2 if split_len > rows else 1)


@functools.cache
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def _scratch_for(device: torch.device, groups: int, plan: SplitPlan):
    """The partials and the arrival counters, kept per (device, shape): the
    kernel leaves the counters at 0, so a call reuses them with no
    allocation.  Calls that share them must run in order (one stream, or a
    CUDA graph replayed on it); the first call of a shape must come before
    any graph capture, so the counters are zeroed on the device."""
    key = (device, groups, plan.heads, plan.n_split)
    if key not in _scratch:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("flash_decode: call it once at this shape "
                               "before capturing it in a CUDA graph")
        rows = groups * plan.heads * plan.n_split
        _scratch[key] = (
            torch.empty((rows, 2), dtype=torch.float32, device=device),
            torch.empty((rows, DMAX), dtype=torch.float32, device=device),
            torch.zeros((groups,), dtype=torch.int32, device=device))
    return _scratch[key]


def _aligned(t: torch.Tensor, strides) -> bool:
    """The pointer and the given strides are whole multiples of 16 bytes."""
    es = t.element_size()
    return t.data_ptr() % 16 == 0 and all(s * es % 16 == 0 for s in strides)


@functools.cache
def _kernel():
    lib = _build.load("flash_decode")
    fn = lib.flash_decode_launch
    fn.argtypes = [_P] * 9 + [_I] * 10 + [_L] * 10 + [_F, _I, _I, _P]
    fn.restype = _I
    return fn


def flash_decode(q: torch.Tensor, k_cache: torch.Tensor,
                 v_cache: torch.Tensor, cache_len: torch.Tensor, *,
                 return_lse: bool = False):
    """q: (b, h, d); caches: (b, kh, S, d); cache_len: (b,) int32.

    q and the caches are float32 or bfloat16, independently; any strides
    with a unit last stride, so a layer's slice of the model cache
    (layers, b, S, kh, d) is read in place through ``permute``.  d <= 128.
    Returns (b, h, d) in q's dtype; with ``return_lse``, (out (b, h, d)
    float32, lse (b, h) float32 in natural-log units, ``NEG_INF`` where
    cache_len is 0).
    """
    global launches
    kernels.refuse_grad("flash_decode", (q, k_cache, v_cache))
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
    out = torch.empty((b, h, d), device=q.device,
                      dtype=torch.float32 if return_lse else q.dtype)
    lse = torch.empty((b, h), dtype=torch.float32, device=q.device) \
        if return_lse else None
    if b * h == 0 or S == 0:
        out.zero_()
        return (out, lse.fill_(NEG_INF)) if return_lse else out
    plan = split_plan(b, kh, h // kh, S, _sm_count(q.device.index))
    part_ml, part_acc, counter = _scratch_for(
        q.device, b * kh * plan.n_gchunks, plan)
    chunk = 16 // k_cache.element_size()
    vec = d % chunk == 0 and all(
        _aligned(c, c.stride()[:3]) for c in (k_cache, v_cache))
    with torch.cuda.device(q.device):
        err = _kernel()(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            cache_len.data_ptr(), out.data_ptr(),
            lse.data_ptr() if return_lse else None, part_ml.data_ptr(),
            part_acc.data_ptr(), counter.data_ptr(), b, h, kh, S, d,
            plan.heads, plan.split_len, plan.n_split, plan.stages, int(vec),
            *q.stride()[:2], *k_cache.stride()[:3], *v_cache.stride()[:3],
            *out.stride()[:2], d ** -0.5, _DTYPES[q.dtype],
            _DTYPES[k_cache.dtype],
            torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_decode kernel launch failed: CUDA error "
                           f"{err}")
    launches += 1
    return (out, lse) if return_lse else out
