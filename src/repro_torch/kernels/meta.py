"""wkv6 on meta tensors: the plain version as a custom op with flop formulas.

Meta tensors hold no data, so ``ops`` sends them down the plain versions,
as it does CPU tensors.  For ``wkv6`` that path (``ref.wkv6_chunked``)
walks its chunks in Python, one set of ops a chunk and a layer, which is
too slow to trace at rwkv6-3b's 32k prefill (512 chunks x 32 layers).
``register()`` defines ``repro_torch::wkv6_plain`` and its backward
``repro_torch::wkv6_plain_bwd`` as custom ops.  On meta tensors their fake
versions give each output's shape in one call, and
``torch.utils.flop_counter`` counts them by ``wkv6_flops`` and
``wkv6_bwd_flops``, which equal its own count of ``ref.wkv6_chunked`` and of
autograd's backward of it (every input but ``reset`` requiring grad) at the
same shape.  On the CPU the ops run the plain versions, so their values can
be checked too.  Nothing is registered until ``register()`` is called; a
``FlopCounterMode`` made before that call does not know the formulas.

The custom ops' signatures are read from their annotations at
``register()``, so this module has no ``from __future__ import
annotations``.
"""
import functools

import torch
from torch import Tensor

from repro_torch.kernels import ref


def _chunks(s: int, chunk: int) -> tuple[int, int]:
    """``ref.wkv6_chunked``'s chunk length and count (it asserts whole
    chunks, and so does this)."""
    L = min(chunk, s)
    if s % L:
        raise ValueError(f"wkv6 plain version: s={s} is not a multiple of "
                         f"its chunk length {L}")
    return L, s // L


def wkv6_flops(shape, chunk: int) -> int:
    """``FlopCounterMode``'s count of ``ref.wkv6_chunked`` on r of
    ``shape`` (b, s, h, dk).  Per chunk and (batch, head): the state term
    r @ S and the state's update (2 L dk^2 each), the pair weights and
    their product with v (2 L^2 dk each), the diagonal bonus (2 L dk)."""
    b, s, h, dk = shape
    L, nc = _chunks(s, chunk)
    return b * h * nc * (4 * L * dk * dk + 4 * L * L * dk + 2 * L * dk)


def wkv6_bwd_flops(shape, chunk: int) -> int:
    """``FlopCounterMode``'s count of autograd's backward of
    ``ref.wkv6_chunked`` on r of ``shape``, with r, k, v, loga and u
    requiring grad.  Each product takes a gradient for both operands (twice
    its forward count), except that the first chunk's r @ S meets a zero
    state that needs none, and the last chunk's state update reaches no
    output: a chunk gives 2 L dk^2 + 8 L^2 dk + 4 L dk, and each of the
    nc - 1 states carried on gives 6 L dk^2 more."""
    b, s, h, dk = shape
    L, nc = _chunks(s, chunk)
    per_chunk = 2 * L * dk * dk + 8 * L * L * dk + 4 * L * dk
    return b * h * (nc * per_chunk + (nc - 1) * 6 * L * dk * dk)


@functools.cache
def register():
    """Define the two custom ops and their flop formulas, once; returns
    ``torch.ops.repro_torch.wkv6_plain``."""
    from torch.utils.flop_counter import register_flop_formula

    @torch.library.custom_op("repro_torch::wkv6_plain", mutates_args=())
    def wkv6_plain(r: Tensor, k: Tensor, v: Tensor, loga: Tensor, u: Tensor,
                   reset: Tensor, chunk: int) -> tuple[Tensor, Tensor]:
        return ref.wkv6_chunked(r, k, v, loga, u, chunk=chunk, reset=reset,
                                return_state=True)

    @wkv6_plain.register_fake
    def _(r, k, v, loga, u, reset, chunk):
        b, s, h, dk = r.shape
        _chunks(s, chunk)
        return r.new_empty(r.shape), r.new_empty((b, h, dk, dk))

    @torch.library.custom_op("repro_torch::wkv6_plain_bwd", mutates_args=())
    def wkv6_plain_bwd(r: Tensor, k: Tensor, v: Tensor, loga: Tensor,
                       u: Tensor, reset: Tensor, dout: Tensor, chunk: int
                       ) -> tuple[Tensor, Tensor, Tensor, Tensor, Tensor]:
        # no autograd below a custom op: the explicit decomposition
        return tuple(ref.wkv6_bwd_two_pass(r, k, v, loga, u, reset, dout,
                                           chunk=chunk)[:5])

    @wkv6_plain_bwd.register_fake
    def _(r, k, v, loga, u, reset, dout, chunk):
        _chunks(r.shape[1], chunk)
        return tuple(t.new_empty(t.shape) for t in (r, k, v, loga, u))

    def setup_context(ctx, inputs, output):
        *saved, chunk = inputs
        ctx.save_for_backward(*saved)
        ctx.chunk = chunk

    def backward(ctx, dout, dstate):
        r, k, v, loga, u, reset = ctx.saved_tensors
        grads = wkv6_plain_bwd(r, k, v, loga, u, reset, dout.contiguous(),
                               ctx.chunk)
        return (*grads, None, None)

    wkv6_plain.register_autograd(backward, setup_context=setup_context)

    @register_flop_formula(torch.ops.repro_torch.wkv6_plain)
    def _(r, *args, out_shape=None, **kwargs):
        return wkv6_flops(r, args[5])

    @register_flop_formula(torch.ops.repro_torch.wkv6_plain_bwd)
    def _(r, *args, out_shape=None, **kwargs):
        return wkv6_bwd_flops(r, args[6])

    return torch.ops.repro_torch.wkv6_plain
