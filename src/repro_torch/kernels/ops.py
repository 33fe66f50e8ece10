"""Public attention ops: the CUDA kernels on the card, plain versions on the CPU.

The port of ``repro.kernels.ops``.  The device of the inputs decides: CUDA
tensors go to the hand-written kernels (which launch or raise; nothing falls
back), CPU tensors go to ``kernels.ref`` because the caller put them there.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import flash_decode as _flash_decode
from repro_torch.kernels import packed_attention as _packed_attention
from repro_torch.kernels import ref


def packed_attention(q, k, v, q_seg, kv_seg, *, causal: bool = True
                     ) -> torch.Tensor:
    """Layout: q (b, h, sq, d); k/v (b, kh, sk, d); segs (b, s)."""
    if q.device.type == "cpu":
        return ref.packed_attention_ref(q, k, v, q_seg, kv_seg, causal=causal)
    return _packed_attention.packed_attention(q, k, v, q_seg, kv_seg,
                                              causal=causal)


def decode_attention(q, k_cache, v_cache, cache_len) -> torch.Tensor:
    """Layout: q (b, h, d); caches (b, kh, S, d); cache_len (b,)."""
    if q.device.type == "cpu":
        return ref.flash_decode_ref(q, k_cache, v_cache, cache_len)
    return _flash_decode.flash_decode(q, k_cache, v_cache, cache_len)
