"""The rest of the port's dense family vs the JAX package, on the CPU:
reduced yi-9b (GQA 4/2 at the reduced size), granite-20b (MQA: every q head
on one kv head) and qwen3-32b (qk-norm, head_dim = d_model / heads).

JAX draws the weights (``init_params(key(0), float32)``) and the same numpy
tree reaches the port through ``params_from_jax``; the batches come from
``tests/conftest.make_lm_batch``.  float32 logits and caches agree to
atol = rtol = 2e-3 (tests/test_models.py); train steps are held to
``tests/test_torch_train.py``'s tolerances.  The reduced configs' JAX
``attn_chunk`` is a field the port's ``ModelConfig`` does not carry (its
attention is the packed kernel or its plain version, unchunked).
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import make_lm_batch
from repro.kernels import ref as jref
from repro.models.model_zoo import build_model as jax_build_model
from repro.train import optimizer as jopt
from repro.train import train_step as jts

from repro_torch.kernels import ref
from repro_torch.models.convert import params_from_jax, train_state_from_jax
from repro_torch.models.params import tree_leaves
from repro_torch.train import train_step as ts
from repro_torch.train.optimizer import AdamWConfig

from test_torch_train import GRAD_REL_L2, LOSS_TOL, OPT, UPDATE_REL_L2

F32_TOL = dict(atol=2e-3, rtol=2e-3)
ARCHS = {"yi-9b": "yi_9b", "granite-20b": "granite_20b",
         "qwen3-32b": "qwen3_32b"}


def _reduced(pkg: str, arch: str):
    return importlib.import_module(f"{pkg}.configs.{ARCHS[arch]}").reduced()


@pytest.fixture(scope="module", params=sorted(ARCHS))
def setup(request):
    """(port cfg, JAX model, JAX params, numpy params, jitted JAX prefill
    and decode step) of one reduced arch."""
    arch = request.param
    cfg, jcfg = _reduced("repro_torch", arch), _reduced("repro", arch)
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init(jax.random.key(0), jnp.float32)
    return (cfg, jmodel, jparams, jax.tree.map(np.asarray, jparams),
            jax.jit(jmodel.prefill), jax.jit(jmodel.decode_step))


def _tb(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def _close(got: torch.Tensor, exp, tol=F32_TOL):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(exp, np.float32), **tol)


def test_dense_forward_matches_jax(setup):
    cfg, jmodel, jparams, np_tree, _, _ = setup
    batch = make_lm_batch(cfg, 2, 64)            # 2 segments and padding
    exp, _ = jax.jit(jmodel.forward)(jparams, batch)
    with torch.no_grad():
        got, aux = params_from_jax(np_tree, cfg, "cpu")(_tb(batch))
    assert got.shape == (2, 64, cfg.vocab_size) and float(aux) == 0.0
    _close(got, exp)


def test_dense_prefill_matches_jax(setup):
    cfg, _, jparams, np_tree, jprefill, _ = setup
    batch = make_lm_batch(cfg, 2, 32, n_segments=1, trailing_pad=0)
    exp_logits, exp_kv = jprefill(jparams, batch)
    with torch.no_grad():
        got_logits, got_kv = params_from_jax(np_tree, cfg, "cpu").prefill(
            _tb(batch))
    _close(got_logits, exp_logits)
    for n in ("k", "v"):
        assert got_kv[n].shape == exp_kv[n].shape
        assert got_kv[n].shape[3] == cfg.num_kv_heads
        _close(got_kv[n], exp_kv[n])


def test_dense_greedy_decode_matches_jax(setup):
    """Prefill 16 positions, move the cache into one of 16 + 6 positions,
    then 6 greedy decode steps: logits agree at every step and the greedy
    tokens are equal."""
    cfg, _, jparams, np_tree, jprefill, jdecode = setup
    b, s, gen = 2, 16, 6
    batch = make_lm_batch(cfg, b, s, n_segments=1, trailing_pad=0)
    model = params_from_jax(np_tree, cfg, "cpu")
    jlogits, jkv = jprefill(jparams, batch)
    jcache = jax.tree.map(
        lambda x: jnp.pad(x, ((0, 0), (0, 0), (0, gen), (0, 0), (0, 0))),
        jkv)
    jtoks, toks = [], []
    with torch.no_grad():
        logits, kv = model.prefill(_tb(batch))
        cache = model.init_cache(b, s + gen, torch.float32)
        for n in ("k", "v"):
            cache[n][:, :, :s] = kv[n]
        for t in range(s, s + gen):
            jcur = jnp.argmax(jlogits[:, -1:], -1).astype(jnp.int32)
            cur = torch.argmax(logits[:, -1:], -1).to(torch.int32)
            jtoks.append(np.asarray(jcur))
            toks.append(cur.numpy())
            jlogits, jcache = jdecode(jparams, jcache, jcur, jnp.int32(t))
            logits, cache = model.decode_step(cache, cur, t)
            _close(logits, jlogits)
    np.testing.assert_array_equal(np.concatenate(toks, 1),
                                  np.concatenate(jtoks, 1))


def test_dense_train_steps_match_jax(setup):
    """From one JAX train state: the loss and every leaf's gradient against
    ``jax.value_and_grad`` of the JAX loss, then three AdamW steps (each
    step's loss, and what the steps added to each leaf), bf16 compute on
    both sides, at tests/test_torch_train.py's tolerances."""
    cfg, jmodel, _, _, _, _ = setup
    jstate = jts.init_train_state(jmodel, jax.random.key(0))
    batch = make_lm_batch(cfg, 2, 64, seed=0)
    np_state = jax.tree.map(np.asarray, jstate)
    (jtotal, _), jgrads = jax.jit(jax.value_and_grad(
        jts.make_loss_fn(jmodel), has_aux=True))(jstate.params, batch)
    model, state = train_state_from_jax(np_state, cfg, "cpu")
    total, _ = ts.make_loss_fn(model)(state.params, _tb(batch))
    total.backward()
    assert abs(total.item() - float(jtotal)) < LOSS_TOL
    for (path, p), (_, g) in zip(tree_leaves(state.params),
                                 tree_leaves(jax.tree.map(np.asarray,
                                                          jgrads))):
        g = np.asarray(g, np.float64)
        assert np.abs(g).max() > 0, path
        rel = np.linalg.norm(p.grad.double().numpy() - g) / np.linalg.norm(g)
        assert rel < GRAD_REL_L2, (path, rel)
        p.grad = None

    before = dict(tree_leaves(np_state.params))
    jstep = jax.jit(jts.make_train_step(jmodel, jopt.AdamWConfig(**OPT)))
    step = ts.make_train_step(model, AdamWConfig(**OPT))
    for _ in range(3):
        jstate, jm = jstep(jstate, batch)
        state, m = step(state, _tb(batch))
        assert abs(m["loss"].item() - float(jm["loss"])) < LOSS_TOL
    for (path, p), (_, e) in zip(tree_leaves(state.params),
                                 tree_leaves(jax.tree.map(np.asarray,
                                                          jstate.params))):
        exp = np.asarray(e, np.float64) - before[path]
        got = p.detach().double().numpy() - before[path]
        assert np.abs(exp).max() > 0, path
        rel = np.linalg.norm(got - exp) / np.linalg.norm(exp)
        assert rel < UPDATE_REL_L2, (path, rel)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_serve_main_dense_on_cpu_returns_tokens(arch):
    from repro_torch.launch import serve
    cfg = _reduced("repro_torch", arch)
    out = serve.main(["--arch", arch, "--reduced", "--device", "cpu",
                      "--batch", "2", "--prompt-len", "16", "--gen", "4"])
    assert out["tokens"].shape == (2, 4)
    assert ((out["tokens"] >= 0) & (out["tokens"] < cfg.vocab_size)).all()
    assert torch.isfinite(out["prefill_logits"].float()).all()
    assert torch.isfinite(out["logits"].float()).all()


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_launcher_trains_a_dense_arch_on_the_cpu(arch):
    from repro_torch.launch import train
    out = train.main(["--arch", arch, "--reduced", "--device", "cpu",
                      "--steps", "2", "--seq-len", "128"])
    hist = out["history"]
    assert len(hist) == 2 and np.isfinite([r["loss"] for r in hist]).all()
    assert out["trainer"].model.cfg.name == f"{arch}-reduced"


@pytest.mark.parametrize("arch,dims,count", [
    ("yi-9b", (48, 4096, 32, 4, 128, 11_008, 64_000), 8_829_407_232),
    ("granite-20b", (52, 6144, 48, 1, 128, 24_576, 49_152), 28_167_493_632),
    ("qwen3-32b", (64, 5120, 64, 8, 80, 25_600, 151_936), 30_497_192_960),
])
def test_dense_configs_are_the_reference_ones(arch, dims, count):
    """The full-width configs, and their parameter counts from shapes."""
    from repro.configs import get_config as jax_get_config
    from repro_torch.configs import get_config
    from repro_torch.models.model_zoo import model_defs
    from repro_torch.models.params import param_count
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    assert (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
            cfg.resolved_head_dim(), cfg.d_ff, cfg.vocab_size) == dims
    assert (cfg.family, cfg.qk_norm, cfg.rope_theta, cfg.tied_embeddings) \
        == (jcfg.family, jcfg.qk_norm, jcfg.rope_theta, jcfg.tied_embeddings)
    assert param_count(model_defs(cfg)) == count \
        == jax_build_model(jcfg).param_count()
    red, jred = _reduced("repro_torch", arch), _reduced("repro", arch)
    assert (red.num_layers, red.d_model, red.num_heads, red.num_kv_heads,
            red.d_ff, red.vocab_size, red.resolved_head_dim()) == (
        jred.num_layers, jred.d_model, jred.num_heads, jred.num_kv_heads,
        jred.d_ff, jred.vocab_size, jred.resolved_head_dim())


@pytest.mark.parametrize("h,kh,s,d", [(8, 1, 96, 32), (6, 1, 130, 16),
                                      (8, 2, 70, 16)])
def test_packed_attention_bwd_bf16_ref_matches_jax_vjp(h, kh, s, d):
    """The backward's bf16-operand yardstick (the long-group check on the
    card holds MQA to it): on bf16 inputs it agrees with ``jax.vjp`` of the
    JAX package's float32 ``packed_attention_ref`` at the bf16 tolerance,
    and it does round where ``packed_attention_bwd_ref`` does not."""
    rng = np.random.default_rng([h, kh, s, d])
    bf = torch.bfloat16
    x = {n: torch.tensor(rng.normal(size=shape), dtype=torch.float32).to(bf)
         for n, shape in (("q", (2, h, s, d)), ("k", (2, kh, s, d)),
                          ("v", (2, kh, s, d)), ("dout", (2, h, s, d)))}
    seg = np.ones((2, s), np.int32)
    seg[0, s // 3:] = 2
    seg[1, s - 9:] = 0
    tseg = torch.from_numpy(seg)
    q, k, v, dout = (x[n] for n in ("q", "k", "v", "dout"))
    out = ref.packed_attention_ref(q, k, v, tseg, tseg)
    lse = ref.packed_attention_lse_ref(q, k, tseg, tseg)
    got = ref.packed_attention_bwd_bf16_ref(q, k, v, out, lse, dout, tseg,
                                            tseg)
    plain = ref.packed_attention_bwd_ref(q, k, v, out, lse, dout, tseg, tseg)
    f32 = {n: t.float().numpy() for n, t in x.items()}
    _, vjp = jax.vjp(lambda a, b_, c: jref.packed_attention_ref(
        a, b_, c, seg, seg), f32["q"], f32["k"], f32["v"])
    for name, g, p, e in zip("qkv", got, plain,
                             vjp(jnp.asarray(f32["dout"]))):
        assert g.shape == e.shape and g.dtype == bf, name
        np.testing.assert_allclose(g.float().numpy(), np.asarray(e),
                                   atol=2e-2, rtol=2e-2, err_msg=name)
        assert not torch.equal(g, p), name
