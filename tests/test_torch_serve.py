"""The port's serving slice vs the JAX package on reduced qwen3-8b.

JAX draws the weights (``init_params(key(0), float32)``); the norm scales
are then perturbed away from 1 in numpy (unit scales would hide a wrong
bf16 cast, since bf16(1.0) is exact), and the same numpy tree goes to JAX
and, through ``params_from_jax``, to the port (on the CPU, where attention
runs the plain versions).  float32 logits agree to atol = rtol = 2e-3, the
tolerance of tests/test_models.py.
"""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from conftest import make_lm_batch
from repro.configs.qwen3_8b import reduced as jax_reduced
from repro.models.model_zoo import build_model as jax_build_model
from repro.train import train_step as jax_train_step

from repro_torch.configs.qwen3_8b import reduced
from repro_torch.launch import serve
from repro_torch.models.convert import params_from_jax
from repro_torch.models.params import tree_leaves
from repro_torch.train.train_step import make_decode_step, make_prefill_step

F32_TOL = dict(atol=2e-3, rtol=2e-3)
# bf16 weights and activations: the two frameworks round matmul outputs,
# SiLU and the norms' products at different places, so logits (|x| < ~5
# here) differ by a bf16 ulp or two: 2^-5 = 0.031 at |x| in [4, 8).
BF16_TOL = dict(atol=3e-2, rtol=3e-2)


@pytest.fixture(scope="module")
def setup():
    cfg, jcfg = reduced(), jax_reduced()
    jmodel = jax_build_model(jcfg)
    np_tree = jax.tree.map(np.asarray, jmodel.init(jax.random.key(0),
                                                   jnp.float32))
    rng = np.random.default_rng(0)

    def perturb(tree):
        return {k: perturb(v) if isinstance(v, dict) else
                (v + rng.normal(size=v.shape).astype(np.float32) * 0.3
                 if k == "scale" else v)
                for k, v in tree.items()}

    np_tree = perturb(np_tree)
    jparams = jax.tree.map(jnp.asarray, np_tree)
    return cfg, jmodel, jparams, np_tree


def _tb(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def _close(got: torch.Tensor, exp, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(exp, np.float32), **tol)


def test_params_from_jax_is_strict(setup):
    cfg, _, _, np_tree = setup
    model = params_from_jax(np_tree, cfg, "cpu")
    assert set(model.state_dict()) == {p for p, _ in tree_leaves(np_tree)}
    assert model.state_dict()["layers.attn.wq"].shape[0] == cfg.num_layers
    bad = dict(np_tree, final_norm={"scale": np.ones(3, np.float32)})
    with pytest.raises(RuntimeError, match="size mismatch"):
        params_from_jax(bad, cfg, "cpu")
    missing = {k: v for k, v in np_tree.items() if k != "final_norm"}
    with pytest.raises(RuntimeError, match="Missing key"):
        params_from_jax(missing, cfg, "cpu")


def test_forward_matches_jax_on_packed_batch(setup):
    cfg, jmodel, jparams, np_tree = setup
    batch = make_lm_batch(cfg, 2, 64)   # 2 segments + trailing padding
    assert (batch["segment_ids"][:, -1] == 0).all()
    exp, _ = jax.jit(jmodel.forward)(jparams, batch)
    with torch.no_grad():
        got, aux = params_from_jax(np_tree, cfg, "cpu")(_tb(batch))
    assert got.shape == (2, 64, cfg.vocab_size) and float(aux) == 0.0
    _close(got, exp, F32_TOL)


def test_prefill_matches_jax(setup):
    cfg, jmodel, jparams, np_tree = setup
    batch = make_lm_batch(cfg, 2, 32, n_segments=1, trailing_pad=0)
    exp_logits, exp_kv = jax.jit(jmodel.prefill)(jparams, batch)
    with torch.no_grad():
        got_logits, got_kv = params_from_jax(np_tree, cfg, "cpu").prefill(
            _tb(batch))
    assert got_logits.shape == (2, 1, cfg.vocab_size)
    _close(got_logits, exp_logits, F32_TOL)
    for n in ("k", "v"):
        assert got_kv[n].shape == exp_kv[n].shape
        _close(got_kv[n], exp_kv[n], F32_TOL)


def test_decode_replay_and_greedy_match_jax(setup):
    """16 prompt tokens replayed through decode_step, then greedy decode;
    logits agree at every step and the greedy tokens are equal."""
    cfg, jmodel, jparams, np_tree = setup
    b, s, gen = 2, 16, 4
    batch = make_lm_batch(cfg, b, s, n_segments=1, trailing_pad=0)
    model = params_from_jax(np_tree, cfg, "cpu")
    jdecode = jax.jit(jmodel.decode_step)
    jcache = jmodel.init_cache(b, s + gen, jnp.float32)
    cache = model.init_cache(b, s + gen, torch.float32)
    toks = batch["tokens"]
    jtoks, ttoks = [], []
    with torch.no_grad():
        for t in range(s + gen):
            if t < s:
                jcur, cur = toks[:, t:t + 1], torch.from_numpy(
                    toks[:, t:t + 1])
            else:
                jcur = jnp.argmax(jlogits[:, -1:], -1).astype(jnp.int32)
                cur = torch.argmax(logits[:, -1:], -1).to(torch.int32)
                jtoks.append(np.asarray(jcur))
                ttoks.append(cur.numpy())
            jlogits, jcache = jdecode(jparams, jcache, jcur, jnp.int32(t))
            logits, cache = model.decode_step(cache, cur, t)
            _close(logits, jlogits, F32_TOL)
    np.testing.assert_array_equal(np.concatenate(ttoks, 1),
                                  np.concatenate(jtoks, 1))
    _close(cache["k"], jcache["k"], F32_TOL)


def test_bf16_serve_path_matches_jax(setup):
    """make_prefill_step / make_decode_step cast like JAX's
    ``_cast_for_compute``: every float32 leaf of rank > 1 (the stacked
    per-layer norm scales included) to bf16, ``final_norm.scale`` kept in
    float32.  The cast leaves are compared exactly, then the logits."""
    cfg, jmodel, jparams, np_tree = setup
    model = params_from_jax(np_tree, cfg, "cpu")
    prefill = make_prefill_step(model)
    decode = make_decode_step(model)
    jcast = jax_train_step._cast_for_compute(jparams)
    state = model.state_dict()
    for path, leaf in tree_leaves(jax.tree.map(np.asarray, jcast)):
        got = state[path]
        assert str(got.dtype).split(".")[-1] == leaf.dtype.name, path
        np.testing.assert_array_equal(got.float().numpy(),
                                      leaf.astype(np.float32), err_msg=path)
    assert state["layers.attn_norm.scale"].dtype == torch.bfloat16
    assert state["layers.attn.q_norm.scale"].dtype == torch.bfloat16
    assert state["final_norm.scale"].dtype == torch.float32

    b, s = 2, 16
    batch = make_lm_batch(cfg, b, s, n_segments=1, trailing_pad=0)
    exp, _ = jax.jit(jax_train_step.make_prefill_step(jmodel))(jparams,
                                                                batch)
    got, _ = prefill(_tb(batch))
    assert got.dtype == torch.bfloat16
    _close(got, exp, BF16_TOL)

    jdecode = jax.jit(jax_train_step.make_decode_step(jmodel))
    jcache = jmodel.init_cache(b, s, jnp.float32)
    cache = model.init_cache(b, s, torch.float32)
    for t in range(s):
        jlogits, jcache = jdecode(jparams, jcache,
                                  batch["tokens"][:, t:t + 1], jnp.int32(t))
        logits, cache = decode(cache, _tb(batch)["tokens"][:, t:t + 1], t)
    _close(logits, jlogits, BF16_TOL)


def test_packed_segments_are_independent(setup):
    """Packing isolation: a segment's logits must not depend on the other
    segments packed into the same row."""
    cfg, _, _, np_tree = setup
    model = params_from_jax(np_tree, cfg, "cpu")
    rng = np.random.default_rng(0)
    s = 64
    a = rng.integers(1, cfg.vocab_size, 24).astype(np.int32)
    bpart = rng.integers(1, cfg.vocab_size, 30).astype(np.int32)
    c = rng.integers(1, cfg.vocab_size, 30).astype(np.int32)

    def packed(second):
        tokens = np.zeros((1, s), np.int32)
        seg = np.zeros((1, s), np.int32)
        pos = np.zeros((1, s), np.int32)
        tokens[0, :24] = a
        seg[0, :24] = 1
        pos[0, :24] = np.arange(24)
        tokens[0, 24:54] = second
        seg[0, 24:54] = 2
        pos[0, 24:54] = np.arange(30)
        return _tb(dict(tokens=tokens, segment_ids=seg, positions=pos))

    with torch.no_grad():
        l1, _ = model(packed(bpart))
        l2, _ = model(packed(c))
    torch.testing.assert_close(l1[0, :24], l2[0, :24], atol=1e-4, rtol=1e-4)


def test_serve_main_on_cpu_returns_tokens():
    out = serve.main(["--reduced", "--device", "cpu", "--batch", "2",
                      "--prompt-len", "8", "--gen", "4"])
    assert out["tokens"].shape == (2, 4)
    assert ((out["tokens"] >= 0) & (out["tokens"] < reduced().vocab_size)
            ).all()
    assert torch.isfinite(out["logits"].float()).all()
    assert torch.isfinite(out["prefill_logits"].float()).all()
