"""The port's Mamba2 block and zamba2 hybrid vs the JAX package, on the CPU.

JAX draws the weights (``init_params(key(0), float32)``) and the same numpy
tree reaches the port through ``params_from_jax``; the batches come from
``tests/conftest.make_lm_batch``.  Tolerances: logits and caches atol =
rtol = 2e-3 (tests/test_models.py:57); the float32 Mamba2 block alone
BLOCK_TOL, tighter, whose worst case here reaches 0.25 of it (measured on
the CPU); packing isolation 1e-4 (tests/test_models.py:107);
train steps at tests/test_torch_train.py's tolerances.  The reduced config
has no tail (4 layers, a shared block every 2); ``TAIL`` adds a fifth
layer, so prefill and decode also run the tail's states.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import make_lm_batch
from repro.models import params as jparams_lib
from repro.models import ssm as jssm
from repro.models.model_zoo import build_model as jax_build_model
from repro.train import optimizer as jopt
from repro.train import train_step as jts

from repro_torch.models import ssm
from repro_torch.models.convert import params_from_jax, train_state_from_jax
from repro_torch.models.params import tree_leaves
from repro_torch.train import train_step as ts
from repro_torch.train.optimizer import AdamWConfig

from test_torch_train import GRAD_REL_L2, LOSS_TOL, OPT, UPDATE_REL_L2

F32_TOL = dict(atol=2e-3, rtol=2e-3)
BLOCK_TOL = dict(atol=2e-5, rtol=2e-5)
ISOLATION_TOL = dict(atol=1e-4, rtol=1e-4)
TAIL = 5            # layers: two blocks of 2 and a tail of 1


def _cfgs(layers=None):
    cfg = importlib.import_module("repro_torch.configs.zamba2_7b").reduced()
    jcfg = importlib.import_module("repro.configs.zamba2_7b").reduced()
    if layers:
        cfg, jcfg = (c.replace(num_layers=layers) for c in (cfg, jcfg))
    return cfg, jcfg


@pytest.fixture(scope="module", params=[None, TAIL], ids=["reduced", "tail"])
def setup(request):
    """(port cfg, JAX model, JAX params, numpy params)."""
    cfg, jcfg = _cfgs(request.param)
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init(jax.random.key(0), jnp.float32)
    return cfg, jmodel, jparams, jax.tree.map(np.asarray, jparams)


def _tb(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def _close(got: torch.Tensor, exp, tol=F32_TOL):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(exp, np.float32), **tol)


# ------------------------------------------------------------ Mamba2 block
def _block(seed=0):
    """(cfg, JAX block params, the same as torch tensors)."""
    cfg, jcfg = _cfgs()
    jp = jparams_lib.init_params(jssm.mamba2_def(jcfg), jax.random.key(seed),
                                 jnp.float32)
    # nonzero dt_bias and A_log, so decays differ by head and position
    r = np.random.default_rng(seed)
    H = jp["A_log"].shape[0]
    jp = dict(jp, A_log=jnp.asarray(r.normal(size=H) * 0.5, jnp.float32),
              dt_bias=jnp.asarray(r.normal(size=H) * 0.5, jnp.float32))
    tp = {k: (torch.from_numpy(np.array(v)) if not isinstance(v, dict)
              else {kk: torch.from_numpy(np.array(vv))
                    for kk, vv in v.items()}) for k, v in jp.items()}
    return cfg, jcfg, jp, tp


def _packed_segments(b, s):
    """Rows of segments that start mid-chunk (chunk 16), short ones, and
    trailing padding."""
    seg = np.zeros((b, s), np.int32)
    seg[0, :21], seg[0, 21:24], seg[0, 24:50], seg[0, 50:60] = 1, 2, 3, 4
    seg[1, :40], seg[1, 40:61] = 1, 2
    return seg


@pytest.mark.parametrize("return_state", [False, True])
def test_mamba2_train_matches_jax_on_packed_rows(return_state):
    cfg, jcfg, jp, tp = _block()
    b, s = 2, 64
    rng = np.random.default_rng(1)
    x = rng.normal(size=(b, s, cfg.d_model)).astype(np.float32)
    seg = _packed_segments(b, s)
    exp = jssm.mamba2_train(jp, jcfg, jnp.asarray(x), jnp.asarray(seg),
                            return_state=return_state)
    got = ssm.mamba2_train(tp, cfg, torch.from_numpy(x),
                           torch.from_numpy(seg), return_state=return_state)
    if not return_state:
        _close(got, exp, BLOCK_TOL)
        return
    _close(got[0], exp[0], BLOCK_TOL)
    assert set(got[1]) == set(exp[1]) == {"ssm", "conv"}
    for n in ("ssm", "conv"):
        assert got[1][n].dtype == torch.float32
        assert tuple(got[1][n].shape) == exp[1][n].shape
        _close(got[1][n], exp[1][n], BLOCK_TOL)


def test_mamba2_decode_steps_from_the_prefill_state():
    """A 32-token prefix through ``mamba2_train(return_state=True)``, then
    16 ``mamba2_decode`` steps from its state: every step's output and
    state against JAX, and the steps against the train path run on all 48
    tokens (the state carries the prefix exactly)."""
    cfg, jcfg, jp, tp = _block(2)
    b, s, n = 2, 32, 16
    rng = np.random.default_rng(3)
    x = rng.normal(size=(b, s + n, cfg.d_model)).astype(np.float32)
    seg = np.ones((b, s), np.int32)
    _, jst = jssm.mamba2_train(jp, jcfg, jnp.asarray(x[:, :s]),
                               jnp.asarray(seg), return_state=True)
    _, st = ssm.mamba2_train(tp, cfg, torch.from_numpy(x[:, :s]),
                             torch.from_numpy(seg), return_state=True)
    full = ssm.mamba2_train(tp, cfg, torch.from_numpy(x),
                            torch.ones((b, s + n), dtype=torch.int32))
    for t in range(s, s + n):
        xt = x[:, t:t + 1]
        jy, jst = jssm.mamba2_decode(jp, jcfg, jnp.asarray(xt), jst)
        y, st = ssm.mamba2_decode(tp, cfg, torch.from_numpy(xt), st)
        _close(y, jy, BLOCK_TOL)
        for k in ("ssm", "conv"):
            _close(st[k], jst[k], BLOCK_TOL)
        _close(y[:, 0], full[:, t].numpy(), BLOCK_TOL)


def test_conv_leaks_across_packed_boundaries_and_the_state_does_not():
    """The reference's packing contract: the SSM state resets at a segment
    start (changing segment 1 more than CONV_K - 1 tokens before the
    boundary leaves segment 2's outputs alone, to float32 rounding), while
    the depthwise conv window reaches CONV_K - 1 tokens back across it
    (changing segment 1's last token moves the conv's output at segment
    2's first CONV_K - 1 positions, and no later one, and through them
    segment 2's outputs).  JAX shows the same."""
    cfg, jcfg, jp, tp = _block(4)
    b, s, cut, k = 1, 64, 24, ssm.CONV_K - 1
    rng = np.random.default_rng(5)
    x = rng.normal(size=(b, s, cfg.d_model)).astype(np.float32)
    seg = np.zeros((b, s), np.int32)
    seg[0, :cut], seg[0, cut:] = 1, 2
    far, near = x.copy(), x.copy()
    far[:, :cut - k] = rng.normal(size=(b, cut - k, cfg.d_model))
    near[:, cut - 1] += 1.0
    stream = rng.normal(size=(b, s, 2 * cfg.d_model)).astype(np.float32)
    bumped = stream.copy()
    bumped[:, cut - 1] += 1.0
    for mod, p, c, conv in ((ssm, tp, cfg, torch.from_numpy),
                            (jssm, jp, jcfg, jnp.asarray)):
        def run(inp):
            return np.asarray(mod.mamba2_train(p, c, conv(inp), conv(seg)))

        def window(inp):
            return np.asarray(mod._causal_depthwise_conv(conv(inp),
                                                         p["conv"]))
        base = run(x)
        np.testing.assert_allclose(run(far)[:, cut:], base[:, cut:],
                                   **ISOLATION_TOL)
        assert np.abs(run(near)[:, cut:] - base[:, cut:]).max() > 1e-2
        moved = np.abs(window(bumped) - window(stream)).max(-1)[0]
        assert (moved[cut - 1:cut + k] > 0).all(), moved
        assert not moved[cut + k:].any() and not moved[:cut - 1].any()


# ------------------------------------------------------------ the hybrid
def test_hybrid_forward_matches_jax(setup):
    cfg, jmodel, jparams, np_tree = setup
    batch = make_lm_batch(cfg, 2, 64, n_segments=3, trailing_pad=5)
    exp, _ = jax.jit(jmodel.forward)(jparams, batch)
    with torch.no_grad():
        got, aux = params_from_jax(np_tree, cfg, "cpu")(_tb(batch))
    assert got.shape == (2, 64, cfg.vocab_size) and float(aux) == 0.0
    _close(got, exp)


def test_hybrid_prefill_matches_jax(setup):
    """The last logits and every cache leaf: the Mamba2 states of the
    blocks (flat) and of the tail, and the shared block's k and v."""
    cfg, jmodel, jparams, np_tree = setup
    batch = make_lm_batch(cfg, 2, 32, n_segments=2, trailing_pad=4)
    exp_logits, exp_cache = jax.jit(jmodel.prefill)(jparams, batch)
    with torch.no_grad():
        got_logits, got_cache = params_from_jax(
            np_tree, cfg, "cpu").prefill(_tb(batch))
    _close(got_logits, exp_logits)
    exp_leaves = dict(tree_leaves(jax.tree.map(np.asarray, exp_cache)))
    got_leaves = dict(tree_leaves(got_cache))
    assert set(got_leaves) == set(exp_leaves) == {
        "blocks.ssm", "blocks.conv", "tail.ssm", "tail.conv", "k", "v"}
    n_tail = cfg.num_layers % cfg.attn_every
    assert got_leaves["tail.ssm"].shape[0] == n_tail
    for path, exp in exp_leaves.items():
        got = got_leaves[path]
        assert tuple(got.shape) == exp.shape, path
        assert str(got.dtype).split(".")[-1] == exp.dtype.name, path
        _close(got, exp)


def test_hybrid_prompt_replay_and_greedy_decode_match_jax(setup):
    """As the serve launchers run it: 16 prompt tokens replayed through
    decode_step on a fresh float32 cache, then greedy decode; logits agree
    at every step, the greedy tokens are equal, and so is every cache
    leaf at the end."""
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
            _close(logits, jlogits)
    np.testing.assert_array_equal(np.concatenate(ttoks, 1),
                                  np.concatenate(jtoks, 1))
    for path, exp in tree_leaves(jax.tree.map(np.asarray, jcache)):
        got = dict(tree_leaves(cache))[path]
        assert got.dtype == torch.float32, path
        _close(got, exp)


def test_hybrid_packed_segments_are_independent(setup):
    """Packing isolation through the whole hybrid, as
    tests/test_models.py:92 holds the dense family: segment 1's logits do
    not move when segment 2 changes (the conv leaks forward only)."""
    cfg, _, _, np_tree = setup
    rng = np.random.default_rng(0)
    s = 64
    a = rng.integers(1, cfg.vocab_size, 24)
    seg = np.zeros((1, s), np.int32)
    seg[0, :24], seg[0, 24:54] = 1, 2
    pos = np.zeros((1, s), np.int32)
    pos[0, :24], pos[0, 24:54] = np.arange(24), np.arange(30)
    model = params_from_jax(np_tree, cfg, "cpu")
    outs = []
    for second in (rng.integers(1, cfg.vocab_size, 30),
                   rng.integers(1, cfg.vocab_size, 30)):
        tokens = np.zeros((1, s), np.int32)
        tokens[0, :24], tokens[0, 24:54] = a, second
        with torch.no_grad():
            outs.append(model(_tb(dict(tokens=tokens, segment_ids=seg,
                                       positions=pos)))[0])
    torch.testing.assert_close(outs[0][0, :24], outs[1][0, :24],
                               **ISOLATION_TOL)
    assert not torch.allclose(outs[0][0, 24:54], outs[1][0, 24:54])


def test_hybrid_compute_cast_is_jax_rule():
    """``_cast_for_compute`` (the serve steps' cast) follows JAX's rule on
    the hybrid's shapes: the twice-stacked (n_blocks, attn_every, ...)
    leaves, norm scales and per-head vectors included, become bf16; the
    one shared block's projections too, but its norm scales (rank 1) and
    ``final_norm`` stay float32.  Every leaf equals JAX's cast bitwise."""
    cfg, jcfg = _cfgs()
    jmodel = jax_build_model(jcfg)
    jp = jmodel.init(jax.random.key(0), jnp.float32)
    model = params_from_jax(jax.tree.map(np.asarray, jp), cfg, "cpu")
    ts.make_decode_step(model)
    state = model.state_dict()
    for path, leaf in tree_leaves(jax.tree.map(
            np.asarray, jts._cast_for_compute(jp))):
        got = state[path]
        assert str(got.dtype).split(".")[-1] == leaf.dtype.name, path
        np.testing.assert_array_equal(got.float().numpy(),
                                      leaf.astype(np.float32), err_msg=path)
    for path in ("blocks.mixer.A_log", "blocks.mixer.D", "blocks.norm.scale",
                 "blocks.mixer.norm.scale", "shared_attn.attn.wq"):
        assert state[path].dtype == torch.bfloat16, path
    assert state["blocks.mixer.dt_bias"].shape == (
        cfg.num_layers // cfg.attn_every, cfg.attn_every,
        2 * cfg.d_model // cfg.ssm_head_dim)
    for path in ("shared_attn.attn_norm.scale", "shared_attn.mlp_norm.scale",
                 "final_norm.scale"):
        assert state[path].dtype == torch.float32, path


@pytest.fixture
def float32_compute(monkeypatch):
    """Both frameworks' train steps compute on the float32 masters instead
    of a bf16 copy (``test_hybrid_grads_and_train_steps_match_jax`` says
    why)."""
    monkeypatch.setattr(jts, "_cast_for_compute",
                        lambda params, compute_dtype=None: params)
    monkeypatch.setattr(ts, "COMPUTE_DTYPE", torch.float32)


def test_hybrid_grads_and_train_steps_match_jax(float32_compute):
    """From one JAX train state of the reduced config with a tail: the
    loss and every leaf's gradient (the shared block's summed over its
    applications) against ``jax.value_and_grad`` of the JAX loss, then
    three AdamW steps, at tests/test_torch_train.py's tolerances, with
    both sides' compute cast off (float32), as tests/test_torch_rwkv_train
    holds RWKV6: in bf16 this model's gradients are rounding in JAX alone,
    whose bf16 gradients of this loss lie 0.04-0.053 (relative L2) from
    its own float32 ones, past GRAD_REL_L2 (measured on the CPU)."""
    cfg, jcfg = _cfgs(TAIL)
    jmodel = jax_build_model(jcfg)
    jstate = jts.init_train_state(jmodel, jax.random.key(0))
    batch = make_lm_batch(cfg, 2, 64, seed=0)
    np_state = jax.tree.map(np.asarray, jstate)
    (jtotal, _), jgrads = jax.jit(jax.value_and_grad(
        jts.make_loss_fn(jmodel), has_aux=True))(jstate.params, batch)
    model, state = train_state_from_jax(np_state, cfg, "cpu")
    total, _ = ts.make_loss_fn(model)(state.params, _tb(batch))
    total.backward()
    assert abs(total.item() - float(jtotal)) < LOSS_TOL
    paths = []
    for (path, p), (_, g) in zip(tree_leaves(state.params),
                                 tree_leaves(jax.tree.map(np.asarray,
                                                          jgrads))):
        g = np.asarray(g, np.float64)
        assert np.abs(g).max() > 0, path
        rel = np.linalg.norm(p.grad.double().numpy() - g) / np.linalg.norm(g)
        assert rel < GRAD_REL_L2, (path, rel)
        p.grad = None
        paths.append(path)
    assert "shared_attn.attn.wq" in paths and "tail.mixer.A_log" in paths

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


def test_shared_block_gradient_is_the_sum_over_its_applications():
    """The one shared block applied after each of the blocks: its gradient
    equals the sum of the gradients that separate copies, one an
    application, would get (float32, no compute cast).  Under the remat
    policy (each block one checkpoint) the block runs again in the
    backward, last block first, so the copies are handed out in that order
    a second time."""
    from repro_torch.models import hybrid
    cfg, jcfg = _cfgs(TAIL)
    jp = jax_build_model(jcfg).init(jax.random.key(1), jnp.float32)
    model = params_from_jax(jax.tree.map(np.asarray, jp), cfg, "cpu")
    model.requires_grad_(True)
    batch = _tb(make_lm_batch(cfg, 2, 32, seed=1))
    params = model.tree()
    model(batch)[0].square().mean().backward()
    shared = {p: t.grad.clone() for p, t in tree_leaves(
        params["shared_attn"])}
    n_blocks = cfg.num_layers // cfg.attn_every
    copies = [{k: {kk: v.detach().clone().requires_grad_()
                   for kk, v in t.items()} if isinstance(t, dict)
               else t.detach().clone().requires_grad_()
               for k, t in params["shared_attn"].items()}
              for _ in range(n_blocks)]
    apply = hybrid._shared_attn_apply
    calls = iter(copies + copies[::-1])
    try:
        hybrid._shared_attn_apply = lambda sp, *a: apply(next(calls), *a)
        model(batch)[0].square().mean().backward()
    finally:
        hybrid._shared_attn_apply = apply
    for path, g in shared.items():
        summed = sum(dict(tree_leaves(c))[path].grad for c in copies)
        torch.testing.assert_close(g, summed, atol=1e-6, rtol=1e-5)


def test_serve_main_hybrid_on_cpu_returns_tokens():
    from repro_torch.launch import serve
    cfg, _ = _cfgs()
    out = serve.main(["--arch", "zamba2-7b", "--reduced", "--device", "cpu",
                      "--batch", "2", "--prompt-len", "16", "--gen", "4"])
    assert out["tokens"].shape == (2, 4)
    assert ((out["tokens"] >= 0) & (out["tokens"] < cfg.vocab_size)).all()
    assert torch.isfinite(out["prefill_logits"].float()).all()
    assert torch.isfinite(out["logits"].float()).all()
    assert out["cache"]["blocks"]["ssm"].abs().max() > 0


def test_launcher_trains_the_hybrid_on_the_cpu():
    from repro_torch.launch import train
    out = train.main(["--arch", "zamba2-7b", "--reduced", "--device", "cpu",
                      "--steps", "2", "--seq-len", "128"])
    hist = out["history"]
    assert len(hist) == 2 and np.isfinite([r["loss"] for r in hist]).all()
    assert out["trainer"].model.cfg.name == "zamba2-7b-reduced"


def test_zamba2_config_is_the_reference_one():
    """Field by field, less ``attn_chunk`` (the port's attention tiles the
    keys itself), full and reduced; the parameter count from shapes."""
    import dataclasses
    from repro.configs import get_config as jax_get_config
    from repro_torch.configs import get_config
    from repro_torch.models.model_zoo import model_defs
    from repro_torch.models.params import param_count
    cfg, jcfg = get_config("zamba2-7b"), jax_get_config("zamba2-7b")
    for c, j in ((cfg, jcfg), _cfgs()):
        for f in dataclasses.fields(c):
            assert getattr(c, f.name) == getattr(j, f.name), f.name
    assert param_count(model_defs(cfg)) == 6_750_498_384 \
        == jax_build_model(jcfg).param_count()
