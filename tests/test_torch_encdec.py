"""The port's Whisper encoder-decoder vs the JAX package, on the CPU.

JAX draws the weights (``init_params(key(0), float32)``) and the same numpy
tree reaches the port through ``params_from_jax``; the batches come from
``tests/conftest.make_lm_batch`` (float32 ``enc_embeds`` of
``encoder_frames`` frames).  Tolerances: float32 logits and caches atol =
rtol = 2e-3 (tests/test_models.py:57); bf16 weights and activations
BF16_TOL (tests/test_torch_serve.py: a bf16 ulp or two of the logits);
``gelu_mlp`` alone GELU_TOL, tighter, whose worst case here reaches 0.036
of it while the erf form lies 46x past it (measured on the CPU); train
steps at tests/test_torch_train.py's tolerances.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from conftest import make_lm_batch
from repro.models import encdec as jencdec
from repro.models import layers as jlayers
from repro.models import params as jparams_lib
from repro.models.model_zoo import build_model as jax_build_model
from repro.train import optimizer as jopt
from repro.train import train_step as jts

from repro_torch.models import encdec
from repro_torch.models import layers as L
from repro_torch.models.convert import params_from_jax, train_state_from_jax
from repro_torch.models.params import tree_leaves
from repro_torch.train import train_step as ts
from repro_torch.train.optimizer import AdamWConfig

from test_torch_train import GRAD_REL_L2, LOSS_TOL, OPT, UPDATE_REL_L2

F32_TOL = dict(atol=2e-3, rtol=2e-3)
BF16_TOL = dict(atol=3e-2, rtol=3e-2)
GELU_TOL = dict(atol=1e-5, rtol=1e-5)


def _cfgs():
    return tuple(importlib.import_module(
        f"{pkg}.configs.whisper_medium").reduced()
        for pkg in ("repro_torch", "repro"))


@pytest.fixture(scope="module")
def setup():
    """(port cfg, JAX model, JAX params, numpy params)."""
    cfg, jcfg = _cfgs()
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init(jax.random.key(0), jnp.float32)
    return cfg, jmodel, jparams, jax.tree.map(np.asarray, jparams)


def _tb(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def _close(got: torch.Tensor, exp, tol=F32_TOL):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(exp, np.float32), **tol)


def test_gelu_mlp_is_the_tanh_form():
    """``jax.nn.gelu`` defaults to the tanh approximation and ``F.gelu`` to
    erf: the port's ``gelu_mlp`` agrees with JAX's at GELU_TOL, and the
    same MLP with the erf form does not."""
    jp = jparams_lib.init_params(jlayers.gelu_mlp_def(64, 128),
                                 jax.random.key(0), jnp.float32)
    r = np.random.default_rng(0)
    jp = dict(jp, b_up=jnp.asarray(r.normal(size=128) * 0.5, jnp.float32))
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    x = r.normal(size=(2, 16, 64)).astype(np.float32) * 2
    exp = np.asarray(jlayers.gelu_mlp(jp, jnp.asarray(x)))
    got = L.gelu_mlp(tp, torch.from_numpy(x))
    _close(got, exp, GELU_TOL)
    erf = F.gelu(torch.from_numpy(x) @ tp["w_up"] + tp["b_up"]) \
        @ tp["w_down"] + tp["b_down"]
    assert not np.allclose(erf.numpy(), exp, **GELU_TOL)


def test_encode_matches_jax(setup):
    cfg, jmodel, jparams, np_tree = setup
    batch = make_lm_batch(cfg, 2, 32)
    exp = jax.jit(lambda p, e: jencdec.encode(p, jmodel.cfg, e))(
        jparams, batch["enc_embeds"])
    model = params_from_jax(np_tree, cfg, "cpu")
    with torch.no_grad():
        got = encdec.encode(model.tree(), cfg,
                            torch.from_numpy(batch["enc_embeds"]))
    assert got.shape == (2, cfg.encoder_frames, cfg.d_model)
    _close(got, exp)


def test_forward_matches_jax(setup):
    """float32 weights, a packed decoder batch (2 segments, padding)."""
    cfg, jmodel, jparams, np_tree = setup
    batch = make_lm_batch(cfg, 2, 64)
    exp, _ = jax.jit(jmodel.forward)(jparams, batch)
    with torch.no_grad():
        got, aux = params_from_jax(np_tree, cfg, "cpu")(_tb(batch))
    assert got.shape == (2, 64, cfg.vocab_size) and float(aux) == 0.0
    _close(got, exp)


def test_forward_promotes_float32_enc_embeds_like_jax(setup):
    """bf16 weights (JAX's compute cast, the serve steps' cast) with float32
    ``enc_embeds``, as the serve launchers feed them: the encoder runs in
    float32 (float32 activation times bf16 weight promotes, as in JAX),
    the decoder in bf16, and its cross-attention on a bf16 q and float32
    keys in float32; logits bf16 and within BF16_TOL of JAX's."""
    cfg, jmodel, jparams, np_tree = setup
    batch = make_lm_batch(cfg, 2, 64)
    jcast = jts._cast_for_compute(jparams)
    exp, _ = jax.jit(jmodel.forward)(jcast, batch)
    jenc = jax.jit(lambda p, e: jencdec.encode(p, jmodel.cfg, e))(
        jcast, batch["enc_embeds"])
    assert exp.dtype == jnp.bfloat16 and jenc.dtype == jnp.float32
    model = params_from_jax(np_tree, cfg, "cpu")
    ts.make_prefill_step(model)           # the serve steps' cast
    tb = _tb(batch)
    with torch.no_grad():
        enc = encdec.encode(model.tree(), cfg, tb["enc_embeds"])
        got, _ = model(tb)
    assert enc.dtype == torch.float32 and got.dtype == torch.bfloat16
    _close(enc, jenc, F32_TOL)
    _close(got, exp, BF16_TOL)


def test_prefill_and_cross_cache_match_jax(setup):
    """The last logits and the cache: the self-attention k and v of the
    prompt and the cross k and v of the encoder states, bf16."""
    cfg, jmodel, jparams, np_tree = setup
    batch = make_lm_batch(cfg, 2, 32, n_segments=1, trailing_pad=0)
    exp_logits, exp_cache = jax.jit(jmodel.prefill)(jparams, batch)
    with torch.no_grad():
        got_logits, got_cache = params_from_jax(
            np_tree, cfg, "cpu").prefill(_tb(batch))
    _close(got_logits, exp_logits)
    assert set(got_cache) == set(exp_cache) == {"k", "v", "cross_k",
                                                "cross_v"}
    for n, exp in exp_cache.items():
        assert tuple(got_cache[n].shape) == exp.shape, n
        assert got_cache[n].dtype == torch.bfloat16, n
        _close(got_cache[n], exp)
    assert got_cache["cross_k"].shape[2] == cfg.encoder_frames


def test_decode_against_the_prefill_cross_cache_matches_jax(setup):
    """Decode that reads the audio: the prefill's self k/v moved into a
    cache of 16 + 6 positions beside the prefill's cross k/v, then greedy
    decode steps: logits agree with JAX at every step and the greedy
    tokens are equal.  Each step's logits also match the port's own
    forward over the prompt and the tokens decoded so far, at BF16_TOL
    (the cross cache is bf16, the forward's cross keys float32)."""
    cfg, jmodel, jparams, np_tree = setup
    b, s, gen = 2, 16, 6
    batch = make_lm_batch(cfg, b, s, n_segments=1, trailing_pad=0)
    model = params_from_jax(np_tree, cfg, "cpu")
    jlogits, jkv = jax.jit(jmodel.prefill)(jparams, batch)
    pad = ((0, 0), (0, 0), (0, gen), (0, 0), (0, 0))
    jcache = dict(jkv, k=jnp.pad(jkv["k"], pad), v=jnp.pad(jkv["v"], pad))
    jdecode = jax.jit(jmodel.decode_step)
    tokens = torch.from_numpy(batch["tokens"])
    jtoks, toks = [], []
    with torch.no_grad():
        logits, kv = model.prefill(_tb(batch))
        cache = model.init_cache(b, s + gen, torch.float32)
        for n in ("k", "v"):
            cache[n][:, :, :s] = kv[n]
        for n in ("cross_k", "cross_v"):
            cache[n].copy_(kv[n])
        assert cache["cross_k"].abs().max() > 0
        for t in range(s, s + gen):
            jcur = jnp.argmax(jlogits[:, -1:], -1).astype(jnp.int32)
            cur = torch.argmax(logits[:, -1:], -1).to(torch.int32)
            jtoks.append(np.asarray(jcur))
            toks.append(cur.numpy())
            tokens = torch.cat([tokens, cur], 1)
            jlogits, jcache = jdecode(jparams, jcache, jcur, jnp.int32(t))
            logits, cache = model.decode_step(cache, cur, t)
            _close(logits, jlogits)
            n = t + 1
            full, _ = model({
                "tokens": tokens, "enc_embeds": _tb(batch)["enc_embeds"],
                "segment_ids": torch.ones((b, n), dtype=torch.int32),
                "positions": torch.arange(n, dtype=torch.int32).expand(
                    b, n)})
            _close(logits[:, 0], full[:, -1].numpy(), BF16_TOL)
    np.testing.assert_array_equal(np.concatenate(toks, 1),
                                  np.concatenate(jtoks, 1))


def test_train_step_with_bf16_enc_embeds_matches_jax():
    """From one JAX state, on a fixed batch whose ``enc_embeds`` are bf16,
    as the card's Whisper training feeds them (``model_zoo.input_specs``
    declares them so): the loss passes them through the batch to the
    encoder; the loss and every leaf's gradient, then three train steps
    (each step's loss, and what the steps added to each leaf) agree with
    JAX's at tests/test_torch_train.py's tolerances, bf16 compute on both
    sides, as tests/test_torch_dense.py holds the dense family.  (After
    one step alone the update is AdamW's first, lr g / (|g| + eps), whose
    sign flips on gradients within rounding of 0: 0.25 relative L2 on
    ``dec_layers.mlp_norm.scale``; after three, 0.051, measured on the
    CPU.)"""
    cfg, jcfg = _cfgs()
    jmodel = jax_build_model(jcfg)
    jstate = jts.init_train_state(jmodel, jax.random.key(0))
    batch = make_lm_batch(cfg, 2, 64, seed=0)
    jbatch = dict(batch, enc_embeds=jnp.asarray(batch["enc_embeds"],
                                                jnp.bfloat16))
    tbatch = dict(_tb(batch), enc_embeds=torch.from_numpy(
        batch["enc_embeds"]).to(torch.bfloat16))
    np_state = jax.tree.map(np.asarray, jstate)
    (jtotal, _), jgrads = jax.jit(jax.value_and_grad(
        jts.make_loss_fn(jmodel), has_aux=True))(jstate.params, jbatch)
    model, state = train_state_from_jax(np_state, cfg, "cpu")
    seen = []
    encode = encdec.encode

    def spy(params, cfg_, enc_embeds):
        seen.append(enc_embeds)
        return encode(params, cfg_, enc_embeds)
    encdec.encode = spy
    try:
        total, _ = ts.make_loss_fn(model)(state.params, tbatch)
    finally:
        encdec.encode = encode
    assert len(seen) == 1 and seen[0] is tbatch["enc_embeds"]
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
        jstate, jm = jstep(jstate, jbatch)
        state, m = step(state, tbatch)
        assert abs(m["loss"].item() - float(jm["loss"])) < LOSS_TOL
    for (path, p), (_, e) in zip(tree_leaves(state.params),
                                 tree_leaves(jax.tree.map(np.asarray,
                                                          jstate.params))):
        exp = np.asarray(e, np.float64) - before[path]
        got = p.detach().double().numpy() - before[path]
        assert np.abs(exp).max() > 0, path
        rel = np.linalg.norm(got - exp) / np.linalg.norm(exp)
        assert rel < UPDATE_REL_L2, (path, rel)


def test_serve_main_tokens_equal_jax_under_c5(monkeypatch, capsys):
    """``serve.main`` at the reduced size on JAX's weights (the JAX
    launcher's ``init(key(0), float32)``) against ``repro.launch.serve``'s
    own run: the same greedy tokens.  Both decode against a cache of zeros
    in place of the cross k/v (ROADMAP.md, C5), so the served tokens never
    read the audio."""
    import sys
    from repro.launch import serve as jserve
    from repro_torch.launch import serve
    cfg, jcfg = _cfgs()
    np_tree = jax.tree.map(np.asarray, jax_build_model(jcfg).init(
        jax.random.key(0), jnp.float32))
    monkeypatch.setattr(serve, "build_model",
                        lambda c, g, dtype: params_from_jax(np_tree, c,
                                                            "cpu"))
    argv = ["--arch", "whisper-medium", "--reduced", "--batch", "2",
            "--prompt-len", "16", "--gen", "4"]
    out = serve.main(argv + ["--device", "cpu"])
    assert out["cache"]["cross_k"].abs().max() == 0
    assert torch.isfinite(out["prefill_logits"].float()).all()
    capsys.readouterr()
    monkeypatch.setattr(sys, "argv", ["serve"] + argv)
    jserve.main()
    line = [ln for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("greedy continuations:")][0]
    assert out["tokens"].tolist() == eval(line.split(":", 1)[1])


def test_whisper_config_is_the_reference_one():
    """Every field of the port's config equals the reference's, full and
    reduced (the reference's ``attn_chunk`` has no counterpart); the
    parameter count from shapes."""
    import dataclasses
    from repro.configs import get_config as jax_get_config
    from repro_torch.configs import get_config
    from repro_torch.models.model_zoo import model_defs
    from repro_torch.models.params import param_count
    cfg, jcfg = get_config("whisper-medium"), jax_get_config("whisper-medium")
    for c, j in ((cfg, jcfg), _cfgs()):
        for f in dataclasses.fields(c):
            assert getattr(c, f.name) == getattr(j, f.name), f.name
    assert param_count(model_defs(cfg)) == 811_358_208 \
        == jax_build_model(jcfg).param_count()
