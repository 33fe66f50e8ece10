"""The port's moe family vs the JAX package, on the CPU: the MoE block
(``models.moe``) and reduced qwen3-moe-30b-a3b, granite-moe-3b-a800m (tied
embeddings, 5 experts padded to 16), paper-tmoe-25b and paper-mixtral-8x7b
(8 experts padded to 16).

JAX draws the weights and the same numpy tree reaches the port through
``params_from_jax``.  Every comparison of values first asserts that both
packages routed each token to the same experts.  Tolerances: the float32
block to 2e-5 (``tests/test_kernels.py:28``); float32 logits, caches and
aux losses to 2e-3 (``tests/test_models.py:57``); a bf16 train step to
``tests/test_torch_train.py``'s.  The two paper backbones have no
``reduced()`` in either package, so ``_reduced`` cuts them here, the same
way on both sides.
"""
import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import make_lm_batch
from repro.models import moe as jmoe
from repro.models.model_zoo import build_model as jax_build_model
from repro.models.params import init_params as jax_init_params
from repro.train import optimizer as jopt
from repro.train import train_step as jts

from repro_torch.models import moe
from repro_torch.models.convert import params_from_jax, train_state_from_jax
from repro_torch.models.model_zoo import build_model
from repro_torch.models.params import tree_leaves
from repro_torch.train import train_step as ts
from repro_torch.train.optimizer import AdamWConfig

from test_torch_train import GRAD_REL_L2, LOSS_TOL, OPT, UPDATE_REL_L2

BLOCK_TOL = dict(atol=2e-5, rtol=2e-5)
F32_TOL = dict(atol=2e-3, rtol=2e-3)
MODULES = {"qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b",
           "granite-moe-3b-a800m": "granite_moe_3b_a800m",
           "paper-tmoe-25b": "paper_vlm", "paper-mixtral-8x7b": "paper_vlm"}
# the paper's backbones: the published heads' layout, experts and top-k
# kept, widths cut as the other reduced configs cut them
PAPER = {"paper-tmoe-25b": ("TMOE_25B", dict(num_heads=4, num_kv_heads=4)),
         "paper-mixtral-8x7b": ("MIXTRAL_8X7B",
                                dict(num_heads=8, num_kv_heads=2))}


def _reduced(pkg: str, arch: str):
    mod = importlib.import_module(f"{pkg}.configs.{MODULES[arch]}")
    if arch not in PAPER:
        return mod.reduced()
    name, heads = PAPER[arch]
    return getattr(mod, name).replace(
        name=f"{arch}-reduced", num_layers=2, d_model=64, d_ff=128,
        vocab_size=256, **heads)


def _jax_reduced(arch: str):
    return _reduced("repro", arch).replace(attn_chunk=32)


@functools.cache
def _jax_model(arch: str):
    """(JAX model, its float32 params from key 0) of one reduced arch, drawn
    once a module by a jitted ``init`` (eager, it compiles an op per leaf
    shape)."""
    jmodel = jax_build_model(_jax_reduced(arch))
    return jmodel, jax.jit(jmodel.init, static_argnums=1)(
        jax.random.key(0), jnp.float32)


def _tb(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def _close(got: torch.Tensor, exp, tol=F32_TOL):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(exp, np.float32), **tol)


def _jax_ids(router, cfg, x):
    """The expert ids of ``repro.models.moe.moe_block``'s routing."""
    probs = jax.nn.softmax(jnp.asarray(x, jnp.float32) @ router, axis=-1)
    return np.asarray(jax.lax.top_k(probs, cfg.experts_per_token)[1])


def _slots_loop(ids: np.ndarray, capacity: int) -> np.ndarray:
    """Each (token, choice) pair's slot, counted pair by pair in token-major
    order within its row and capped at ``capacity``."""
    b = ids.shape[0]
    flat = ids.reshape(b, -1)
    out = np.zeros_like(flat)
    for r in range(b):
        seen = {}
        for j, e in enumerate(flat[r]):
            out[r, j] = min(seen.get(e, 0), capacity)
            seen[e] = seen.get(e, 0) + 1
    return out


# ------------------------------------------------------------------ block
def _block(arch: str, seed: int = 0, **changes):
    """(port cfg, JAX cfg, JAX params, port params requiring grad) of one
    reduced arch's MoE block."""
    cfg = _reduced("repro_torch", arch).replace(**changes)
    jcfg = _reduced("repro", arch).replace(**changes)
    jp = jax_init_params(jmoe.moe_def(jcfg), jax.random.key(seed),
                         jnp.float32)
    tp = {k: torch.from_numpy(np.array(v)).requires_grad_()
          for k, v in jax.tree.map(np.asarray, jp).items()}
    return cfg, jcfg, jp, tp


def _x(cfg, b=2, s=64, seed=0):
    return np.random.default_rng(seed).normal(
        size=(b, s, cfg.d_model)).astype(np.float32)


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b",
                                  "granite-moe-3b-a800m"])
def test_moe_block_and_its_gradients_match_jax(arch):
    """out, aux, and the gradients of x and of every MoE leaf (autograd
    against ``jax.vjp``) for a cotangent on both outputs."""
    cfg, jcfg, jp, tp = _block(arch)
    x = _x(cfg)
    assert tp["w_gate"].shape[0] == 16                   # 8 or 5 -> 16
    np.testing.assert_array_equal(
        moe.route(tp["router"], cfg, torch.from_numpy(x))[2].numpy(),
        _jax_ids(jp["router"], jcfg, x))

    dout = np.random.default_rng(1).normal(size=x.shape).astype(np.float32)

    @jax.jit
    def jax_vjp(p, v, ct):
        outs, vjp = jax.vjp(lambda p, v: jmoe.moe_block(p, jcfg, v), p, v)
        return outs, vjp(ct)
    (jout, jaux), (jgp, jgx) = jax_vjp(jp, jnp.asarray(x), (
        jnp.asarray(dout), jnp.float32(0.7)))
    tx = torch.from_numpy(x).requires_grad_()
    out, aux = moe.moe_block(tp, cfg, tx)
    assert out.dtype == torch.float32 and aux.dtype == torch.float32
    _close(out, jout, BLOCK_TOL)
    _close(aux, jaux, BLOCK_TOL)
    ((out * torch.from_numpy(dout)).sum() + 0.7 * aux).backward()
    _close(tx.grad, jgx, BLOCK_TOL)
    for name in ("router", "w_gate", "w_up", "w_down"):
        assert np.abs(np.asarray(jgp[name])).max() > 0, name
        _close(tp[name].grad, jgp[name], BLOCK_TOL)
    live = tp["w_gate"].grad.abs().amax(dim=(1, 2)) > 0
    assert live.tolist() == [e < cfg.num_experts for e in range(16)]


def test_overflow_pairs_are_dropped_as_jax_drops_them():
    """At capacity factor 0.25 most pairs overflow: the port's slots are
    the pair-by-pair count's, the drops are counted, a token whose every
    pair dropped gets 0, and out and aux are JAX's."""
    cfg, jcfg, jp, tp = _block("qwen3-moe-30b-a3b", capacity_factor=0.25)
    x = _x(cfg)
    C = moe.row_capacity(cfg, 64)
    assert C == 4 == jmoe.row_capacity(jcfg, 64)
    tx = torch.from_numpy(x)
    _, _, ids = moe.route(tp["router"], cfg, tx)
    np.testing.assert_array_equal(ids.numpy(), _jax_ids(jp["router"], jcfg,
                                                         x))
    dest = moe.slots(ids, cfg.num_experts, C).numpy()
    np.testing.assert_array_equal(dest, _slots_loop(ids.numpy(), C))
    # each row keeps min(pairs, C) of each expert's pairs
    kept = sum(np.minimum(np.bincount(r.ravel(), minlength=8), C).sum()
               for r in ids.numpy())
    drops = int((dest == C).sum())
    assert drops == dest.size - kept and drops > dest.size // 2
    with torch.no_grad():
        out, aux = moe.moe_block(tp, cfg, tx)
    jout, jaux = jmoe.moe_block(jp, jcfg, jnp.asarray(x))
    _close(out, jout, BLOCK_TOL)
    _close(aux, jaux, BLOCK_TOL)
    all_dropped = (dest.reshape(2, 64, 2) == C).all(-1)
    assert all_dropped.any()
    assert (out.numpy()[all_dropped] == 0).all()


def test_tied_router_logits_pick_the_lowest_experts():
    """A zero router ties every logit: JAX routes every token to experts
    0..k-1, and so does the port; partial ties keep JAX's order too."""
    cfg, jcfg, jp, tp = _block("qwen3-moe-30b-a3b")
    jp = dict(jp, router=jnp.zeros_like(jp["router"]))
    with torch.no_grad():
        tp["router"].zero_()
    x = _x(cfg)
    exp = np.broadcast_to(np.arange(cfg.experts_per_token), (2, 64, 2))
    np.testing.assert_array_equal(_jax_ids(jp["router"], jcfg, x), exp)
    np.testing.assert_array_equal(
        moe.route(tp["router"], cfg, torch.from_numpy(x))[2].numpy(), exp)
    with torch.no_grad():
        out, aux = moe.moe_block(tp, cfg, torch.from_numpy(x))
    jout, jaux = jmoe.moe_block(jp, jcfg, jnp.asarray(x))
    _close(out, jout, BLOCK_TOL)
    _close(aux, jaux, BLOCK_TOL)

    probs = np.array([[0.2, 0.3, 0.3, 0.2], [0.25, 0.25, 0.25, 0.25],
                      [0.1, 0.4, 0.1, 0.4]], np.float32)
    for k in (1, 2, 3, 4):
        vals, idx = moe.top_k(torch.from_numpy(probs), k)
        jvals, jidx = jax.lax.top_k(jnp.asarray(probs), k)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
        np.testing.assert_array_equal(vals.numpy(), np.asarray(jvals))


def test_padding_tokens_take_capacity_as_in_jax():
    """Rows that open with 16 padding positions (segment 0), at a capacity
    that drops pairs: padding attends to nothing but still routes, so
    other token ids there move the real tokens' logits, the same way in
    both packages."""
    arch = "qwen3-moe-30b-a3b"
    cfg = _reduced("repro_torch", arch).replace(capacity_factor=0.5)
    jmodel = jax_build_model(_jax_reduced(arch).replace(capacity_factor=0.5))
    jparams = _jax_model(arch)[1]
    model = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    batch = make_lm_batch(cfg, 2, 64, seed=2, n_segments=1, trailing_pad=0)
    batch["segment_ids"][:, :16] = 0
    batch["positions"][:, 16:] = np.arange(48)
    other = dict(batch, tokens=batch["tokens"].copy())
    other["tokens"][:, :16] = (other["tokens"][:, :16] + 7) % 255 + 1
    fwd = jax.jit(jmodel.forward)
    real = []
    for b in (batch, other):
        exp, jaux = fwd(jparams, b)
        with torch.no_grad():
            got, aux = model(_tb(b))
        _close(got, exp)
        _close(aux, jaux)
        real.append(got[:, 16:].numpy())
    assert np.abs(real[0] - real[1]).max() > 1e-3


# ----------------------------------------------------------------- models
@pytest.fixture(scope="module", params=sorted(MODULES))
def setup(request):
    """(port cfg, JAX model, JAX params, numpy params) of one reduced arch."""
    arch = request.param
    jmodel, jparams = _jax_model(arch)
    return (_reduced("repro_torch", arch), jmodel, jparams,
            jax.tree.map(np.asarray, jparams))


def test_reduced_forward_and_aux_match_jax(setup):
    """A packed batch (two segments, trailing padding): the logits and the
    layers' summed aux loss."""
    cfg, jmodel, jparams, np_tree = setup
    batch = make_lm_batch(cfg, 2, 64)
    exp, jaux = jax.jit(jmodel.forward)(jparams, batch)
    with torch.no_grad():
        got, aux = params_from_jax(np_tree, cfg, "cpu")(_tb(batch))
    assert got.shape == (2, 64, cfg.vocab_size) and float(aux) > 0
    _close(got, exp)
    _close(aux, jaux)


def test_reduced_prefill_and_greedy_decode_match_jax(setup):
    """Prefill 16 positions, move the cache into one of 16 + 4, then 4
    greedy decode steps (the block on (b, 1, d), capacity
    ``row_capacity(cfg, 1)``): logits and caches agree at every step and
    the greedy tokens are equal."""
    cfg, jmodel, jparams, np_tree = setup
    b, s, gen = 2, 16, 4
    batch = make_lm_batch(cfg, b, s, n_segments=1, trailing_pad=0)
    model = params_from_jax(np_tree, cfg, "cpu")
    jlogits, jkv = jax.jit(jmodel.prefill)(jparams, batch)
    with torch.no_grad():
        logits, kv = model.prefill(_tb(batch))
    _close(logits, jlogits)
    for n in ("k", "v"):
        _close(kv[n], jkv[n])
    jcache = jax.tree.map(
        lambda x: jnp.pad(x, ((0, 0), (0, 0), (0, gen), (0, 0), (0, 0))),
        jkv)
    jdecode = jax.jit(jmodel.decode_step)
    jtoks, toks = [], []
    with torch.no_grad():
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
    for n in ("k", "v"):
        _close(cache[n], jcache[n])


def _next_token(batch: dict) -> dict:
    """Labels: each segment's next tokens, -1 on its last and on padding,
    as the data plane packs them (src/repro/data/packing.py:66).  With the
    tokens themselves as labels, tied embeddings (granite) make the task
    trivial: the loss is ~0.02 and the final norm's gradient ~1e-7, which
    is rounding noise in float32 already."""
    tok, seg = batch["tokens"], batch["segment_ids"]
    same = (seg[:, 1:] == seg[:, :-1]) & (seg[:, 1:] > 0)
    labels = np.full_like(tok, -1)
    labels[:, :-1] = np.where(same, tok[:, 1:], -1)
    return dict(batch, labels=labels)


@pytest.fixture
def forced_routing(monkeypatch):
    """Route the port as JAX routes, layer by layer: JAX's expert ids are
    recorded from inside its jitted step (``jax.debug.callback``; under
    the layer remat each layer reports twice, forward first) and handed to
    the port's ``moe.top_k`` in the order the port routes: its forward,
    layer by layer, then its backward's recompute under the same remat
    policy, last layer first.  bf16 compute rounds the router's
    inputs differently in the two frameworks, which flips near-tied
    experts of a few tokens a layer; ``moved`` counts, for each layer, the
    tokens whose experts the port's own top-k would have changed."""
    jax_ids, queue, moved = [], [], []
    jax_block, own_top_k = jmoe.moe_block, moe.top_k

    def recording(p, cfg, x, **kw):
        probs = jax.nn.softmax(x.astype(jnp.float32) @ p["router"], axis=-1)
        jax.debug.callback(lambda i: jax_ids.append(np.asarray(i)),
                           jax.lax.top_k(probs, cfg.experts_per_token)[1])
        return jax_block(p, cfg, x, **kw)

    def jax_top_k(probs, k):
        ids = torch.from_numpy(np.array(queue.pop(0))).long()
        own = own_top_k(probs, k)[1]
        moved.append(int((own.sort(-1)[0] != ids.sort(-1)[0]).any(-1).sum()))
        return torch.gather(probs, -1, ids), ids

    def take(layers: int):
        """Queue the forward's ids of JAX's last step for the port's
        forward, and again, last layer first, for its recompute."""
        assert len(jax_ids) == 2 * layers
        queue[:] = jax_ids[:layers] + jax_ids[:layers][::-1]
        jax_ids.clear()

    monkeypatch.setattr(jmoe, "moe_block", recording)
    monkeypatch.setattr(moe, "top_k", jax_top_k)
    return take, moved


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "paper-tmoe-25b"])
def test_reduced_train_steps_match_jax(arch, forced_routing):
    """From one state, routed alike (``forced_routing``): the loss, the
    aux loss and every leaf's gradient against ``jax.value_and_grad`` of
    the JAX loss, then three AdamW steps (losses, aux losses, and what the
    steps added to each leaf), at ``tests/test_torch_train.py``'s
    tolerances.  The port's own top-k must agree with JAX's on all but a
    few tokens of every layer.  Measured over seeds 0-4 of this setup for
    these two archs and paper-mixtral-8x7b: loss and aux 4.65e-4,
    gradients 9.3e-3, updates 8.97e-2 at worst, at most 2 of 128 tokens a
    layer moved.  granite's tied table at the reference's init (std 1)
    makes its bf16 logits ~7 and its loss ~47, where a bf16 rounding step
    of the logits moves the loss by up to 1.4e-2: its gradients are held
    in float32 below."""
    cfg = _reduced("repro_torch", arch)
    jmodel, jparams = _jax_model(arch)
    take, moved = forced_routing
    L, tokens = cfg.num_layers, 2 * 64
    jstate = jts.TrainState(jparams, jopt.init_adamw(jparams))
    batch = _next_token(make_lm_batch(cfg, 2, 64, seed=0))
    np_state = jax.tree.map(np.asarray, jstate)
    (jtotal, jm), jgrads = jax.jit(jax.value_and_grad(
        jts.make_loss_fn(jmodel), has_aux=True))(jstate.params, batch)
    take(L)
    model, state = train_state_from_jax(np_state, cfg, "cpu")
    total, m = ts.make_loss_fn(model)(state.params, _tb(batch))
    total.backward()
    assert abs(total.item() - float(jtotal)) < LOSS_TOL
    assert abs(m["aux_loss"].item() - float(jm["aux_loss"])) < LOSS_TOL
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
        take(L)
        state, m = step(state, _tb(batch))
        assert abs(m["loss"].item() - float(jm["loss"])) < LOSS_TOL
        assert abs(m["aux_loss"].item() - float(jm["aux_loss"])) < LOSS_TOL
    for (path, p), (_, e) in zip(tree_leaves(state.params),
                                 tree_leaves(jax.tree.map(np.asarray,
                                                          jstate.params))):
        exp = np.asarray(e, np.float64) - before[path]
        got = p.detach().double().numpy() - before[path]
        assert np.abs(exp).max() > 0, path
        rel = np.linalg.norm(got - exp) / np.linalg.norm(exp)
        assert rel < UPDATE_REL_L2, (path, rel)
    # four forwards (the gradients' and three steps'), each routing every
    # layer twice: the forward and the recompute
    assert len(moved) == 8 * L and max(moved) <= 0.05 * tokens, moved


def test_tied_embeddings_loss_and_gradients_match_jax_in_float32():
    """Reduced granite-moe-3b-a800m (tied embeddings: the table gets the
    embedding's and the unembedding's gradients) in float32, next-token
    labels: the loss with its aux term, and every leaf's gradient, against
    ``jax.value_and_grad`` of the same loss on the JAX model."""
    arch = "granite-moe-3b-a800m"
    cfg = _reduced("repro_torch", arch)
    jmodel, jparams = _jax_model(arch)
    batch = _next_token(make_lm_batch(cfg, 2, 64, seed=0))

    def jloss(params):
        logits, aux = jmodel.forward(params, batch)
        mask = ((batch["labels"] >= 0) & (batch["segment_ids"] > 0)
                ).astype(jnp.float32)
        return jts.cross_entropy(logits, batch["labels"], mask)[0] \
            + jts.AUX_LOSS_WEIGHT * aux
    jtotal, jgrads = jax.jit(jax.value_and_grad(jloss))(jparams)
    model = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    model.requires_grad_(True)
    tb = _tb(batch)
    logits, aux = model(tb)
    mask = ((tb["labels"] >= 0) & (tb["segment_ids"] > 0)).float()
    total = ts.cross_entropy(logits, tb["labels"], mask)[0] \
        + ts.AUX_LOSS_WEIGHT * aux
    total.backward()
    assert float(jtotal) > 10 and abs(total.item() - float(jtotal)) < LOSS_TOL
    for (path, p), (_, g) in zip(tree_leaves(model.tree()),
                                 tree_leaves(jax.tree.map(np.asarray,
                                                          jgrads))):
        g = np.asarray(g, np.float64)
        assert np.abs(g).max() > 0, path
        rel = np.linalg.norm(p.grad.double().numpy() - g) / np.linalg.norm(g)
        assert rel < GRAD_REL_L2, (path, rel)


def test_moe_train_step_routes_and_learns():
    """The port of tests/test_train.py::test_moe_train_step_routes_and_learns
    on the port's own weights."""
    cfg = _reduced("repro_torch", "qwen3-moe-30b-a3b")
    model = build_model(cfg, torch.Generator().manual_seed(0))
    state = ts.init_train_state(model)
    step = ts.make_train_step(model, AdamWConfig(peak_lr=5e-3,
                                                 warmup_steps=2))
    batch = _tb(make_lm_batch(cfg, 4, 64, seed=4))
    losses, auxes = [], []
    for _ in range(8):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
        auxes.append(float(m["aux_loss"]))
    assert losses[-1] < losses[0]
    # aux loss stays near 1.0-ish (balanced routing) and finite
    assert all(np.isfinite(a) and a < 16.0 for a in auxes)


def test_params_from_jax_carries_the_moe_leaves():
    """Every moe leaf arrives with its JAX value; the router keeps its
    float32 override when the rest is loaded in bf16."""
    cfg = _reduced("repro_torch", "granite-moe-3b-a800m")
    np_tree = jax.tree.map(np.asarray, _jax_model("granite-moe-3b-a800m")[1])
    model = params_from_jax(np_tree, cfg, "cpu", torch.bfloat16)
    got = dict(tree_leaves(model.tree()))
    want = dict(tree_leaves(np_tree))
    assert sorted(got) == sorted(want)
    assert {p for p in got if ".moe." in p} == {
        f"layers.moe.{n}" for n in ("router", "w_down", "w_gate", "w_up")}
    assert got["layers.moe.router"].dtype == torch.float32
    np.testing.assert_array_equal(got["layers.moe.router"].numpy(),
                                  want["layers.moe.router"])
    assert got["layers.moe.w_gate"].dtype == torch.bfloat16
    assert got["layers.moe.w_gate"].shape == (2, 16, 48, 64)


def test_serve_main_moe_on_cpu_returns_tokens():
    from repro_torch.launch import serve
    cfg = _reduced("repro_torch", "granite-moe-3b-a800m")
    out = serve.main(["--arch", "granite-moe-3b-a800m", "--reduced",
                      "--device", "cpu", "--batch", "2", "--prompt-len",
                      "16", "--gen", "4"])
    assert out["tokens"].shape == (2, 4)
    assert ((out["tokens"] >= 0) & (out["tokens"] < cfg.vocab_size)).all()
    assert torch.isfinite(out["prefill_logits"].float()).all()
    assert torch.isfinite(out["logits"].float()).all()


def test_launcher_trains_a_moe_on_the_cpu():
    from repro_torch.launch import train
    out = train.main(["--arch", "qwen3-moe-30b-a3b", "--reduced", "--device",
                      "cpu", "--steps", "2", "--seq-len", "128"])
    hist = out["history"]
    assert len(hist) == 2 and np.isfinite([r["loss"] for r in hist]).all()
    assert out["trainer"].model.cfg.family == "moe"


@pytest.mark.parametrize("arch,count", [
    ("qwen3-moe-30b-a3b", 30_532_122_624),
    ("granite-moe-3b-a800m", 3_902_773_248),
    ("paper-tmoe-25b", 35_054_397_440),
    ("paper-mixtral-8x7b", 91_799_949_312),
])
def test_moe_configs_are_the_reference_ones(arch, count):
    """Every field the port keeps is the reference's, and the parameter
    count from the shapes is JAX's (padded experts included)."""
    import dataclasses
    from repro.configs import get_config as jax_get_config
    from repro_torch.configs import get_config
    from repro_torch.models.model_zoo import model_defs
    from repro_torch.models.params import param_count
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    for f in dataclasses.fields(cfg):
        assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name
    assert param_count(model_defs(cfg)) == count \
        == jax_build_model(jcfg).param_count()
    red, jred = _reduced("repro_torch", arch), _reduced("repro", arch)
    for f in dataclasses.fields(red):
        assert getattr(red, f.name) == getattr(jred, f.name), f.name
