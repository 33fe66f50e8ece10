"""Wrapper of the CUDA chunked-WKV6 backward kernel (``csrc/wkv6_bwd.cu``).

No TPU kernel stands behind it: the JAX package differentiates the chunk
scan of ``repro.models.rwkv.wkv6_chunked`` with autodiff.  The kernel gives
the gradients of the ``wkv6`` kernel's function with respect to r, k, v,
loga and u, from dO and the states the forward kernel wrote entering each
chunk (``wkv6.wkv6(..., chunk_states=)``).  ``ops._WKV6`` pairs the two
under autograd.  The wrapper takes CUDA tensors only and raises on anything
the kernel does not take; its plain version is ``ref.wkv6_bwd_ref``, and
``ref.wkv6_bwd_two_pass`` is the kernel's decomposition in plain PyTorch.

Bytes bound the function on the H100 (at rwkv6-3b's training shape its
inputs and outputs take 0.125 ms at 3.35 TB/s, its float32 FMA 0.055 ms
at 67 TFLOP/s).  One call is three kernel launches on the current stream,
with no atomics, so two calls give bitwise-equal gradients:

* pass 1 walks each (b, h) backwards through its chunks for the state's
  gradient leaving each chunk, into scratch, the next chunk's inputs
  coming in by ``cp.async`` while this one is worked;
* pass 2 forms each chunk's gradients and its share of du, two CTAs of 8
  warps on each SM: its pair terms by sub-chunks of 16 tokens (walks at
  most 15 deep on the diagonal blocks, products of factored operands
  below them), launched with programmatic stream serialisation so that
  everything but the terms of the state's gradient overlaps pass 1;
* pass 3 sums du in a fixed order.

``launches`` counts calls.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch import kernels
from repro_torch.kernels import _build
from repro_torch.kernels.wkv6 import _RESET_DTYPES, MAX_CHUNK

launches = 0

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


@functools.cache
def _kernel():
    lib = _build.load("wkv6_bwd")
    fn = lib.wkv6_bwd_launch
    fn.argtypes = [_P] * 15 + [_I] * 6 + [_L] * 20 + [_P]
    fn.restype = _I
    return fn


def chunk_ctas_per_sm() -> int:
    """Pass 2's resident CTAs an SM at rwkv6-3b's shapes (dk 64, chunk 64),
    from the CUDA runtime's occupancy calculator."""
    fn = _build.load("wkv6_bwd").wkv6_bwd_chunk_ctas_per_sm
    fn.argtypes, fn.restype = [], _I
    return fn()


def wkv6_bwd(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             loga: torch.Tensor, u: torch.Tensor, reset: torch.Tensor,
             dout: torch.Tensor, chunk_states: torch.Tensor, *,
             chunk: int = MAX_CHUNK):
    """r, k, v, loga, dout: (b, s, h, dk) float32; u: (h, dk) float32;
    reset: (b, s) bool, uint8 or int32; chunk_states: the forward kernel's
    contiguous float32 (b, h, ceil(s / chunk), dk, dk) states entering each
    chunk, written at the same ``chunk``.

    The forward's limits: any strides with a unit last stride, dk a
    multiple of 4 at most 64, 1 <= chunk <= 64, any s.  Returns dr, dk, dv,
    dloga (b, s, h, dk) and du (h, dk), float32.
    """
    global launches
    kernels.refuse_grad("wkv6_bwd", (r, k, v, loga, u, dout))
    tensors = (r, k, v, loga, u, dout, reset, chunk_states)
    if any(t.device.type != "cuda" or t.device != r.device for t in tensors):
        raise ValueError("wkv6_bwd kernel: all inputs must be on one CUDA "
                         f"device; got {[str(t.device) for t in tensors]}")
    if any(t.dtype != torch.float32 for t in tensors[:6]):
        raise ValueError("wkv6_bwd kernel: r, k, v, loga, u and dout must be "
                         f"float32; got {[t.dtype for t in tensors[:6]]}")
    if r.dim() != 4 or any(t.shape != r.shape for t in (k, v, loga, dout)):
        raise ValueError(f"bad shapes r {tuple(r.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)} loga {tuple(loga.shape)} "
                         f"dout {tuple(dout.shape)}")
    b, s, h, dk = r.shape
    if dk % 4 or not 4 <= dk <= MAX_CHUNK:
        raise ValueError(f"head size {dk} not a multiple of 4 in "
                         f"[4, {MAX_CHUNK}]")
    if not 1 <= chunk <= MAX_CHUNK:
        raise ValueError(f"chunk {chunk} not in [1, {MAX_CHUNK}]")
    if u.shape != (h, dk) or u.stride(1) != 1:
        raise ValueError(f"u must be {(h, dk)} with a unit last stride; got "
                         f"{tuple(u.shape)} strides {u.stride()}")
    if any(t.stride(3) != 1 for t in (r, k, v, loga, dout)):
        raise ValueError("r, k, v, loga, dout need a unit last stride")
    if reset.dtype not in _RESET_DTYPES or reset.shape != (b, s) \
            or reset.stride(1) != 1:
        raise ValueError(f"reset must be bool, uint8 or int32 of shape "
                         f"{(b, s)} with a unit last stride; got "
                         f"{reset.dtype} {tuple(reset.shape)}")
    if reset.dtype == torch.bool:
        reset = reset.view(torch.uint8)
    L = min(chunk, s)
    nc = -(-s // L) if s else 0
    if (chunk_states.shape != (b, h, nc, dk, dk)
            or chunk_states.dtype != torch.float32
            or not chunk_states.is_contiguous()):
        raise ValueError(f"chunk_states must be contiguous float32 "
                         f"{(b, h, nc, dk, dk)}; got {chunk_states.dtype} "
                         f"{tuple(chunk_states.shape)}")
    grads = [torch.empty((b, s, h, dk), dtype=torch.float32, device=r.device)
             for _ in range(4)]
    du = torch.zeros((h, dk), dtype=torch.float32, device=r.device)
    if b * h * s == 0:
        return (*(g.zero_() for g in grads), du)
    dstates = torch.empty_like(chunk_states)
    du_part = torch.empty((b, nc, h, dk), dtype=torch.float32,
                          device=r.device)
    with torch.cuda.device(r.device):
        err = _kernel()(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), loga.data_ptr(),
            u.data_ptr(), reset.data_ptr(), dout.data_ptr(),
            chunk_states.data_ptr(), dstates.data_ptr(),
            *(g.data_ptr() for g in grads), du_part.data_ptr(),
            du.data_ptr(), b, h, s, dk, L, reset.element_size(),
            *r.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *loga.stride()[:3], *dout.stride()[:3], *grads[0].stride()[:3],
            u.stride(0), reset.stride(0),
            torch.cuda.current_stream(r.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"wkv6_bwd kernel launch failed: CUDA error {err}")
    launches += 1
    return (*grads, du)
