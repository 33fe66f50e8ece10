"""Port layers and attention vs ``repro.models`` on the same numpy inputs.

float32 throughout, atol = rtol = 2e-5 (the kernels' float32 tolerance of
tests/test_kernels.py); the port runs on the CPU, where attention goes
through the plain versions in ``repro_torch.kernels.ref``.
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from repro.configs.qwen3_8b import reduced as jax_reduced
from repro.models import attention as jattn
from repro.models import layers as jL

from repro_torch.configs.qwen3_8b import reduced
from repro_torch.models import attention, layers as L

TOL = dict(atol=2e-5, rtol=2e-5)


def _np(rng, *shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _close(got: torch.Tensor, exp):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(exp, np.float32), **TOL)


def test_rmsnorm_matches_jax():
    rng = np.random.default_rng(0)
    x, scale = _np(rng, 2, 5, 64), 1 + _np(rng, 64, scale=0.3)
    _close(L.rmsnorm({"scale": _t(scale)}, _t(x), 1e-6),
           jL.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x), 1e-6))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layernorm_matches_jax(dtype):
    """Population variance and a float32 upcast; the output keeps x's
    dtype (bf16 inputs are compared at the kernels' bf16 tolerance)."""
    rng = np.random.default_rng(3)
    x = _np(rng, 2, 5, 64, scale=2.0) + 0.5
    scale, bias = 1 + _np(rng, 64, scale=0.3), _np(rng, 64, scale=0.3)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    got = L.layernorm({"scale": _t(scale), "bias": _t(bias)},
                      _t(x).to(tdt), 1e-6)
    exp = jL.layernorm({"scale": jnp.asarray(scale),
                        "bias": jnp.asarray(bias)},
                       jnp.asarray(x, jdt), 1e-6)
    assert got.dtype == tdt
    tol = 2e-2 if dtype == "bfloat16" else TOL["atol"]
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(exp, np.float32), atol=tol,
                               rtol=tol)


def test_apply_rope_matches_jax():
    rng = np.random.default_rng(1)
    x = _np(rng, 2, 7, 3, 16)
    pos = rng.integers(0, 5000, size=(2, 7)).astype(np.int32)
    _close(L.apply_rope(_t(x), _t(pos), 1_000_000.0),
           jL.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1_000_000.0))


def test_swiglu_matches_jax():
    rng = np.random.default_rng(2)
    p = {"w_gate": _np(rng, 64, 128, scale=0.1),
         "w_up": _np(rng, 64, 128, scale=0.1),
         "w_down": _np(rng, 128, 64, scale=0.1)}
    x = _np(rng, 2, 5, 64)
    _close(L.swiglu({k: _t(v) for k, v in p.items()}, _t(x)),
           jL.swiglu({k: jnp.asarray(v) for k, v in p.items()},
                     jnp.asarray(x)))


def test_qkv_project_with_qk_norm_matches_jax():
    cfg, jcfg = reduced(), jax_reduced()
    assert cfg.qk_norm
    rng = np.random.default_rng(3)
    hd = cfg.resolved_head_dim()
    p = {"wq": _np(rng, cfg.d_model, cfg.num_heads, hd, scale=0.1),
         "wk": _np(rng, cfg.d_model, cfg.num_kv_heads, hd, scale=0.1),
         "wv": _np(rng, cfg.d_model, cfg.num_kv_heads, hd, scale=0.1),
         "wo": _np(rng, cfg.num_heads, hd, cfg.d_model, scale=0.1),
         "q_norm": {"scale": 1 + _np(rng, hd, scale=0.3)},
         "k_norm": {"scale": 1 + _np(rng, hd, scale=0.3)}}
    x = _np(rng, 2, 9, cfg.d_model)
    pos = np.tile(np.arange(9, dtype=np.int32), (2, 1))
    tp = {k: ({"scale": _t(v["scale"])} if isinstance(v, dict) else _t(v))
          for k, v in p.items()}
    jp = {k: ({"scale": jnp.asarray(v["scale"])} if isinstance(v, dict)
              else jnp.asarray(v)) for k, v in p.items()}
    got = L.qkv_project(tp, cfg, _t(x), _t(pos))
    exp = jL.qkv_project(jp, jcfg, jnp.asarray(x), jnp.asarray(pos))
    for g, e in zip(got, exp):
        _close(g, e)
    _close(L.attn_out_project(tp, got[0]),
           jL.attn_out_project(jp, exp[0]))


def _packed_segs(b, s, pad):
    seg = np.zeros((b, s), np.int32)
    seg[:, :s // 3] = 1
    seg[:, s // 3:s - pad] = 2
    return seg


@pytest.mark.parametrize("kh", [1, 2, 4])
def test_segment_attention_matches_jax_chunked_path(kh):
    """The port passes GQA K/V unexpanded; JAX's chunked scan (chunk < s)
    gets them expanded, as its transformer does."""
    rng = np.random.default_rng(kh)
    b, s, h, d = 2, 64, 4, 16
    q, k, v = _np(rng, b, s, h, d), _np(rng, b, s, kh, d), \
        _np(rng, b, s, kh, d)
    seg = _packed_segs(b, s, pad=5)
    got = attention.segment_attention(_t(q), _t(k), _t(v), _t(seg), _t(seg))
    assert got.shape == (b, s, h, d)
    jk = jattn.expand_kv(jnp.asarray(k), h)
    jv = jattn.expand_kv(jnp.asarray(v), h)
    _close(got, jattn.segment_attention(jnp.asarray(q), jk, jv, seg, seg,
                                        chunk=16))
    _close(attention.full_segment_attention(
        _t(q), attention.expand_kv(_t(k), h), attention.expand_kv(_t(v), h),
        _t(seg), _t(seg)),
        jattn.full_segment_attention(jnp.asarray(q), jk, jv, seg, seg))


def test_decode_attention_matches_jax():
    rng = np.random.default_rng(9)
    b, S, h, kh, d = 3, 40, 4, 2, 16
    q, kc, vc = _np(rng, b, 1, h, d), _np(rng, b, S, kh, d), \
        _np(rng, b, S, kh, d)
    clen = np.array([1, 17, 40], np.int32)
    got = attention.decode_attention(_t(q), _t(kc), _t(vc), _t(clen))
    assert got.shape == (b, 1, h, d)
    _close(got, jattn.decode_attention(jnp.asarray(q), jnp.asarray(kc),
                                       jnp.asarray(vc), jnp.asarray(clen)))
