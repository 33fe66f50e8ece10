"""Wrapper of the CUDA chunked-WKV6 kernel (``csrc/wkv6.cu``).

Replaces the Pallas TPU kernel ``repro.kernels.wkv6.wkv6_forward``: the
RWKV6 recurrence in its chunked form, plus the final state that the JAX
model's ``wkv6_chunked(return_state=True)`` returns.  The wrapper takes
CUDA tensors only and raises on anything the kernel does not take;
``kernels.ops`` sends CPU tensors to ``kernels.ref`` instead.

One call is two kernel launches on the current stream: pass 1 writes the
state entering each chunk to scratch, pass 2 forms every chunk's outputs
from it (``ref.wkv6_two_pass`` is the same decomposition in plain
PyTorch).  ``launches`` counts calls, so a serve run of rwkv6-3b reads 32
(= 64 kernel launches).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch import kernels
from repro_torch.kernels import _build

launches = 0

MAX_CHUNK = 64      # tokens per chunk, and the largest head size
_RESET_DTYPES = (torch.bool, torch.uint8, torch.int32)
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


@functools.cache
def _kernel():
    lib = _build.load("wkv6")
    fn = lib.wkv6_launch
    fn.argtypes = [_P] * 9 + [_I] * 7 + [_L] * 17 + [_P]
    fn.restype = _I
    return fn


def wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         loga: torch.Tensor, u: torch.Tensor, reset: torch.Tensor, *,
         chunk: int = MAX_CHUNK, return_state: bool = False,
         chunk_states: torch.Tensor | None = None):
    """r, k, v, loga: (b, s, h, dk) float32; u: (h, dk) float32; reset:
    (b, s) bool, uint8 or int32, nonzero where a segment starts.

    Any strides with a unit last stride.  dk a multiple of 4, at most 64;
    1 <= chunk <= 64; any s (a ragged last chunk is masked).  Returns
    o (b, s, h, dk) float32, and the final state (b, h, dk, dk) float32 if
    ``return_state``.  ``chunk_states``, a contiguous float32 tensor of
    (b, h, ceil(s / chunk), dk, dk), receives the state entering each
    chunk; without it the wrapper allocates that scratch itself.
    """
    global launches
    kernels.refuse_grad("wkv6", (r, k, v, loga, u))
    tensors = (r, k, v, loga, u, reset)
    if any(t.device.type != "cuda" or t.device != r.device for t in tensors):
        raise ValueError("wkv6 kernel: all inputs must be on one CUDA "
                         f"device; got {[str(t.device) for t in tensors]}")
    if any(t.dtype != torch.float32 for t in tensors[:5]):
        raise ValueError("wkv6 kernel: r, k, v, loga and u must be float32; "
                         f"got {[t.dtype for t in tensors[:5]]}")
    if r.dim() != 4 or any(t.shape != r.shape for t in (k, v, loga)):
        raise ValueError(f"bad shapes r {tuple(r.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)} loga {tuple(loga.shape)}")
    b, s, h, dk = r.shape
    if dk % 4 or not 4 <= dk <= MAX_CHUNK:
        raise ValueError(f"head size {dk} not a multiple of 4 in "
                         f"[4, {MAX_CHUNK}]")
    if not 1 <= chunk <= MAX_CHUNK:
        raise ValueError(f"chunk {chunk} not in [1, {MAX_CHUNK}]")
    if u.shape != (h, dk) or u.stride(1) != 1:
        raise ValueError(f"u must be {(h, dk)} with a unit last stride; got "
                         f"{tuple(u.shape)} strides {u.stride()}")
    if any(t.stride(3) != 1 for t in (r, k, v, loga)):
        raise ValueError("r, k, v, loga need a unit last stride")
    if reset.dtype not in _RESET_DTYPES or reset.shape != (b, s) \
            or reset.stride(1) != 1:
        raise ValueError(f"reset must be bool, uint8 or int32 of shape "
                         f"{(b, s)} with a unit last stride; got "
                         f"{reset.dtype} {tuple(reset.shape)}")
    if reset.dtype == torch.bool:
        reset = reset.view(torch.uint8)
    L = min(chunk, s)
    nc = -(-s // L) if s else 0
    if chunk_states is None:
        chunk_states = torch.empty((b, h, nc, dk, dk), dtype=torch.float32,
                                   device=r.device)
    elif (chunk_states.shape != (b, h, nc, dk, dk)
          or chunk_states.dtype != torch.float32
          or chunk_states.device != r.device
          or not chunk_states.is_contiguous()):
        raise ValueError(f"chunk_states must be contiguous float32 "
                         f"{(b, h, nc, dk, dk)} on {r.device}")
    out = torch.empty((b, s, h, dk), dtype=torch.float32, device=r.device)
    state = torch.empty((b, h, dk, dk), dtype=torch.float32,
                        device=r.device) if return_state else None
    if b * h * s == 0:
        return (out, state.zero_()) if return_state else out
    vec = all(t.data_ptr() % 16 == 0 and all(st % 4 == 0 for st in
                                              t.stride()[:3])
              for t in (r, k, v, loga))
    with torch.cuda.device(r.device):
        err = _kernel()(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), loga.data_ptr(),
            u.data_ptr(), reset.data_ptr(), out.data_ptr(),
            chunk_states.data_ptr(),
            state.data_ptr() if return_state else None, b, h, s, dk,
            L, reset.element_size(), int(vec), *r.stride()[:3],
            *k.stride()[:3], *v.stride()[:3], *loga.stride()[:3],
            *out.stride()[:3], u.stride(0), reset.stride(0),
            torch.cuda.current_stream(r.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"wkv6 kernel launch failed: CUDA error {err}")
    launches += 1
    return (out, state) if return_state else out
