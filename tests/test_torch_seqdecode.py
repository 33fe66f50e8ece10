"""The KV-sequence-parallel decode's parts against the JAX package.

A cache cut into ``n`` contiguous pieces along its sequence: each piece's
partial result from ``ref.flash_decode_ref(..., return_lse=True)`` (the
plain version of ``flash_decode``'s partial, which the CPU and the
dry-run's meta shards run), merged by ``ops.merge_partials`` with plain
reductions over the stacked pieces, against JAX's
``repro.models.attention.decode_attention`` and the Pallas
``repro.kernels.flash_decode.flash_decode`` (interpret mode) on the whole
cache: the same numpy inputs from a seed, float32, within the reference's
kernel tolerance (``tests/test_kernels.py:28``).  The cases: GQA groups 1
(MHA), 4 and all query heads on one KV head (MQA, as granite-20b has it),
head dims 80, 112 and 128, pieces wholly past ``cache_len``, ``cache_len``
on a piece's boundary and inside a piece, and a sequence with no live
position.  The pieces' log-sum-exps also merge to the whole cache's, as a
float64 reckoning gives it.
"""
import math

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_decode as fd_wrapper
from repro_torch.kernels import ops, ref

TOL = 2e-5                      # tests/test_kernels.py:28, float32
B, S, PIECES = 4, 64, 4         # pieces of 16 positions
# per row: all live, on a piece's boundary, inside a piece (so the pieces
# after it are wholly past cache_len), and none live
LENS = (S, 2 * S // PIECES, 17, 0)
# (q heads, KV heads): GQA group 1, 4, and every head on one KV head
HEADS = {"mha": (4, 4), "gqa4": (8, 2), "mqa": (8, 1)}


def _inputs(h, kh, d, seed):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, h, d)).astype(np.float32)
    k = rng.normal(size=(B, kh, S, d)).astype(np.float32)
    v = rng.normal(size=(B, kh, S, d)).astype(np.float32)
    return q, k, v, np.asarray(LENS, np.int32)


def _pieces(q, k, v, lens, n):
    """Each piece's (out, lse), stacked on a new dim 0."""
    q, k, v, lens = (torch.from_numpy(x) for x in (q, k, v, lens))
    step = S // n
    outs, lses = [], []
    for i in range(n):
        mine = (lens - i * step).clamp(0, step).to(torch.int32)
        out, lse = ref.flash_decode_ref(q, k[:, :, i * step:(i + 1) * step],
                                        v[:, :, i * step:(i + 1) * step],
                                        mine, return_lse=True)
        outs.append(out)
        lses.append(lse)
    return torch.stack(outs), torch.stack(lses)


def _stacked_merge(outs, lses):
    return ops.merge_partials(outs, lses,
                              lambda t: t.amax(0, keepdim=True),
                              lambda t: t.sum(0, keepdim=True),
                              torch.float32)[0]


@pytest.mark.parametrize("d", [80, 112, 128])
@pytest.mark.parametrize("heads", list(HEADS))
def test_merged_pieces_equal_jax(heads, d):
    import jax.numpy as jnp
    from repro.kernels.flash_decode import flash_decode as pallas_decode
    from repro.models.attention import decode_attention
    h, kh = HEADS[heads]
    q, k, v, lens = _inputs(h, kh, d, seed=d + h + kh)
    got = _stacked_merge(*_pieces(q, k, v, lens, PIECES)).numpy()
    jax_out = np.asarray(decode_attention(
        jnp.asarray(q)[:, None], jnp.asarray(k).transpose(0, 2, 1, 3),
        jnp.asarray(v).transpose(0, 2, 1, 3), jnp.asarray(lens)))[:, 0]
    pallas = np.asarray(pallas_decode(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v), jnp.asarray(lens),
                                      interpret=True))
    np.testing.assert_allclose(got, jax_out, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got, pallas, rtol=TOL, atol=TOL)
    assert np.abs(got[-1]).max() == 0          # no live position: 0


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_pieces_lse_merge_to_the_whole(n):
    """Each piece's lse is ln sum exp(q.k / sqrt(d)) over its live
    positions (``NEG_INF`` where it has none, its output 0); their
    log-sum-exp is the whole cache's, reckoned in float64."""
    h, kh, d = 8, 2, 128
    q, k, v, lens = _inputs(h, kh, d, seed=n)
    outs, lses = _pieces(q, k, v, lens, n)
    assert torch.isfinite(lses).all() and torch.isfinite(outs).all()
    step = S // n
    for i in range(n):
        empty = torch.from_numpy(lens) <= i * step
        assert (lses[i][empty] == fd_wrapper.NEG_INF).all()
        assert (outs[i][empty] == 0).all()
    kx = np.repeat(k, h // kh, axis=1).astype(np.float64)
    logits = np.einsum("bhd,bhsd->bhs", q.astype(np.float64), kx) / math.sqrt(d)
    for row, length in enumerate(LENS[:-1]):
        want = np.log(np.exp(logits[row, :, :length]).sum(-1))
        whole = torch.logsumexp(lses[:, row].double(), dim=0).numpy()
        np.testing.assert_allclose(whole, want, rtol=1e-5, atol=1e-5)


def test_one_piece_is_the_whole_decode():
    """The partial of the whole cache, merged alone, is the plain decode
    (the output is the float32 one before the cast), and ``merge_partials``
    casts once to the dtype it is given."""
    q, k, v, lens = (torch.from_numpy(x) for x in _inputs(8, 2, 64, seed=3))
    out, lse = ref.flash_decode_ref(q, k, v, lens, return_lse=True)
    assert out.dtype == lse.dtype == torch.float32
    assert lse.shape == (B, 8)
    torch.testing.assert_close(out, ref.flash_decode_ref(q, k, v, lens),
                               rtol=0, atol=0)
    merged = ops.merge_partials(out[None], lse[None],
                                lambda t: t.amax(0, keepdim=True),
                                lambda t: t.sum(0, keepdim=True),
                                torch.bfloat16)[0]
    assert merged.dtype == torch.bfloat16
    torch.testing.assert_close(merged, out.to(torch.bfloat16), rtol=0,
                               atol=0)


def test_decode_partial_takes_the_plain_version_on_cpu():
    q, k, v, lens = (torch.from_numpy(x) for x in _inputs(4, 4, 32, seed=4))
    got = ops.decode_partial(q.to(torch.bfloat16), k, v, lens)
    want = ref.flash_decode_ref(q.to(torch.bfloat16), k, v, lens,
                                return_lse=True)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_the_kernel_wrapper_refuses_cpu_tensors_with_lse():
    """The wrapper launches the kernel or raises; it never takes the plain
    version (``ops`` chooses by device)."""
    q, k, v, lens = (torch.from_numpy(x) for x in _inputs(4, 4, 32, seed=5))
    with pytest.raises(ValueError, match="CUDA"):
        fd_wrapper.flash_decode(q, k, v, lens, return_lse=True)


def test_seq_split_dims_is_empty_for_plain_tensors():
    from repro_torch.sharding.logical import seq_split_dims
    assert seq_split_dims(torch.zeros(2, 2, 8, 4)) == []
