"""The port's vlm family vs the JAX package, on the CPU: reduced
paper-llama-12b (the paper's Table 1 backbone, MHA) and reduced pixtral-12b
(GQA).

JAX draws the weights (``init_params(key(0), float32)``) and the same numpy
tree reaches the port through ``params_from_jax``; the batches come from
``tests/conftest.make_lm_batch``, which puts ``image_token_frac`` of the
positions under image embeddings (every other position from 0).  float32
logits and caches agree to atol = rtol = 2e-3 (tests/test_models.py); a
train step is held to ``tests/test_torch_train.py``'s tolerances.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import make_lm_batch
from repro.models.model_zoo import build_model as jax_build_model
from repro.train import optimizer as jopt
from repro.train import train_step as jts

from repro_torch.models.convert import params_from_jax, train_state_from_jax
from repro_torch.models.model_zoo import build_model
from repro_torch.models.params import tree_leaves
from repro_torch.train import train_step as ts
from repro_torch.train.optimizer import AdamWConfig

from test_torch_train import GRAD_REL_L2, LOSS_TOL, OPT, UPDATE_REL_L2

F32_TOL = dict(atol=2e-3, rtol=2e-3)
ARCHS = {"paper-llama-12b": "paper_vlm", "pixtral-12b": "pixtral_12b"}


def _reduced(pkg: str, arch: str):
    return importlib.import_module(f"{pkg}.configs.{ARCHS[arch]}").reduced()


@pytest.fixture(scope="module", params=sorted(ARCHS))
def setup(request):
    """(port cfg, JAX model, JAX params, numpy params) of one reduced vlm."""
    arch = request.param
    cfg, jcfg = _reduced("repro_torch", arch), _reduced("repro", arch)
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init(jax.random.key(0), jnp.float32)
    return cfg, jmodel, jparams, jax.tree.map(np.asarray, jparams)


def _tb(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def _close(got: torch.Tensor, exp, tol=F32_TOL):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(exp, np.float32), **tol)


def test_vlm_forward_with_image_embeds_matches_jax(setup):
    cfg, jmodel, jparams, np_tree = setup
    batch = make_lm_batch(cfg, 2, 64)          # 2 segments, padding, images
    assert batch["image_embeds"].shape == (2, 16, cfg.d_model)
    exp, _ = jax.jit(jmodel.forward)(jparams, batch)
    with torch.no_grad():
        got, aux = params_from_jax(np_tree, cfg, "cpu")(_tb(batch))
    assert got.shape == (2, 64, cfg.vocab_size) and float(aux) == 0.0
    _close(got, exp)


def test_vlm_prefill_with_image_embeds_matches_jax(setup):
    cfg, jmodel, jparams, np_tree = setup
    batch = make_lm_batch(cfg, 2, 32, n_segments=1, trailing_pad=0)
    exp_logits, exp_kv = jax.jit(jmodel.prefill)(jparams, batch)
    with torch.no_grad():
        got_logits, got_kv = params_from_jax(np_tree, cfg, "cpu").prefill(
            _tb(batch))
    _close(got_logits, exp_logits)
    for n in ("k", "v"):
        assert got_kv[n].shape == exp_kv[n].shape
        _close(got_kv[n], exp_kv[n])


def test_greedy_decode_after_an_image_prefill_matches_jax(setup):
    """Prefill 16 positions (4 under image embeddings), move the cache into
    one of 16 + 4 positions, then 4 greedy decode steps: logits agree at
    every step and the greedy tokens are equal."""
    cfg, jmodel, jparams, np_tree = setup
    b, s, gen = 2, 16, 4
    batch = make_lm_batch(cfg, b, s, n_segments=1, trailing_pad=0)
    model = params_from_jax(np_tree, cfg, "cpu")
    jlogits, jkv = jax.jit(jmodel.prefill)(jparams, batch)
    jcache = jax.tree.map(
        lambda x: jnp.pad(x, ((0, 0), (0, 0), (0, gen), (0, 0), (0, 0))),
        jkv)
    jdecode = jax.jit(jmodel.decode_step)
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


def test_vlm_image_fusion_changes_logits():
    """The port of tests/test_models.py::test_vlm_image_fusion_changes_logits,
    with the JAX test's threshold; a dense config ignores the embeddings."""
    cfg = _reduced("repro_torch", "pixtral-12b")
    model = build_model(cfg, torch.Generator().manual_seed(5))
    batch = _tb(make_lm_batch(cfg, 1, 32, n_segments=1, trailing_pad=0))
    moved = dict(batch, image_embeds=batch["image_embeds"] + 1.0)
    dense = build_model(cfg.replace(family="dense"),
                        torch.Generator().manual_seed(5))
    with torch.no_grad():
        l1, _ = model(batch)
        l2, _ = model(moved)
        d1, _ = dense(batch)
        d2, _ = dense(moved)
        plain, _ = model({k: batch[k] for k in
                          ("tokens", "segment_ids", "positions")})
    assert float((l1 - l2).abs().max()) > 1e-4
    assert torch.equal(d1, d2) and torch.equal(d1, plain)


def test_vlm_train_steps_match_jax(setup):
    """A reduced vlm on a batch with image embeddings, from one state: the
    loss and every leaf's gradient against ``jax.value_and_grad`` of the
    JAX loss, then three AdamW steps (losses, and what the steps added to
    each leaf, as ``tests/test_torch_train.py`` holds the dense model; one
    step alone moves each weight by about lr sign(g), so gradients near 0
    whose sign differs between the two frameworks' bf16 arithmetic weigh
    too much in a single update).  Measured over seeds 0-4 of this setup
    for both archs: loss 1.45e-3, gradients 1.54e-2, updates 6.26e-2 at
    worst, inside the dense tolerances."""
    cfg, jmodel, _, _ = setup
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


def test_serve_main_vlm_on_cpu_returns_tokens():
    from repro_torch.launch import serve
    cfg = _reduced("repro_torch", "pixtral-12b")
    out = serve.main(["--arch", "pixtral-12b", "--reduced", "--device",
                      "cpu", "--batch", "2", "--prompt-len", "16", "--gen",
                      "4"])
    # the JAX launcher's draws, in its order: tokens, then the embeddings
    rng = np.random.default_rng(0)
    tokens = rng.integers(1, cfg.vocab_size, (2, 16)).astype(np.int32)
    embeds = rng.normal(size=(2, 4, cfg.d_model)).astype(np.float32) * 0.02
    np.testing.assert_array_equal(out["batch"]["tokens"].numpy(), tokens)
    np.testing.assert_array_equal(out["batch"]["image_embeds"].numpy(),
                                  embeds)
    np.testing.assert_array_equal(out["batch"]["image_positions"].numpy(),
                                  np.tile(np.arange(4), (2, 1)))
    assert out["tokens"].shape == (2, 4)
    assert ((out["tokens"] >= 0) & (out["tokens"] < cfg.vocab_size)).all()
    assert torch.isfinite(out["prefill_logits"].float()).all()
    assert torch.isfinite(out["logits"].float()).all()


def test_launcher_trains_a_vlm_on_the_cpu():
    from repro_torch.launch import train
    out = train.main(["--arch", "pixtral-12b", "--reduced", "--device",
                      "cpu", "--steps", "2", "--seq-len", "128"])
    hist = out["history"]
    assert len(hist) == 2 and np.isfinite([r["loss"] for r in hist]).all()
    assert out["trainer"].model.cfg.family == "vlm"


@pytest.mark.parametrize("arch,dims,count", [
    ("paper-llama-12b", (45, 4608, 36, 36, 128, 18_432, 128_256),
     16_470_664_704),
    ("pixtral-12b", (40, 5120, 32, 8, 128, 14_336, 131_072), 12_247_782_400),
])
def test_vlm_configs_are_the_reference_ones(arch, dims, count):
    from repro.configs import get_config as jax_get_config
    from repro_torch.configs import get_config
    from repro_torch.models.model_zoo import model_defs
    from repro_torch.models.params import param_count
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    assert (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
            cfg.resolved_head_dim(), cfg.d_ff, cfg.vocab_size) == dims
    assert (cfg.family, cfg.image_token_frac, cfg.rope_theta) == (
        jcfg.family, jcfg.image_token_frac, jcfg.rope_theta)
    assert param_count(model_defs(cfg)) == count \
        == jax_build_model(jcfg).param_count()
