"""The port's training half vs the JAX package: AdamW, the loss, the
gradients and a few train steps of reduced qwen3-8b, on the CPU.

Both sides start from one state: JAX draws it (``init_train_state``), and
the same numpy tree reaches the port through ``train_state_from_jax``.
Attention runs the plain version on the CPU (``kernels.ops``); the CUDA
kernels are checked on the card by ``chip_smoke.py --only train``.

Tolerances, bf16 compute (the reference's loss casts a bf16 copy of the
master weights; the two frameworks round matmul outputs, SiLU and the norms
at different places).  Measured over seeds 0-4 of this setup (2 x 64
tokens, 2 layers): the worst loss difference was 6.5e-4, the worst
per-leaf relative L2 gradient difference 9.5e-3 (``layers.attn.q_norm``),
the worst loss difference over three train steps 6.8e-4, the worst
per-leaf relative L2 difference of what three train steps added to the
params 4.13e-2 (``layers.attn.wk``, seed 2).  The tests hold 3x those:
loss 2e-3, gradients 3e-2, updates 1.25e-1.
"""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from conftest import make_lm_batch
from repro.configs.qwen3_8b import reduced as jax_reduced
from repro.models.model_zoo import build_model as jax_build_model
from repro.train import optimizer as jopt
from repro.train import train_step as jts

from repro_torch.configs.qwen3_8b import reduced
from repro_torch.models.convert import train_state_from_jax
from repro_torch.models.model_zoo import build_model
from repro_torch.models.params import tree_leaves
from repro_torch.train import train_step as ts
from repro_torch.train.optimizer import (
    AdamWConfig, AdamWState, adamw_update, init_adamw, lr_schedule,
)

LOSS_TOL = 2e-3
GRAD_REL_L2 = 3e-2
UPDATE_REL_L2 = 1.25e-1
OPT = dict(peak_lr=5e-3, warmup_steps=5, total_steps=100)


@pytest.fixture(scope="module")
def setup():
    cfg = reduced()
    jmodel = jax_build_model(jax_reduced())
    jstate = jts.init_train_state(jmodel, jax.random.key(0))
    batch = make_lm_batch(cfg, 2, 64, seed=0)
    return cfg, jmodel, jstate, batch


def _tb(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _rel_l2(got: torch.Tensor, exp) -> float:
    exp = np.asarray(exp, np.float64)
    return float(np.linalg.norm(got.detach().double().numpy() - exp)
                 / max(np.linalg.norm(exp), 1e-30))


# ------------------------------------------- AdamW (tests/test_train.py)
def test_adamw_matches_reference_formulas():
    cfg = AdamWConfig(peak_lr=1e-2, warmup_steps=0, total_steps=10**9,
                      weight_decay=0.0, clip_norm=1e9, min_lr_ratio=1.0)
    p = {"w": torch.tensor([1.0, -2.0])}
    g = {"w": torch.tensor([0.5, 0.25])}
    new_p, st1, _ = adamw_update(cfg, g, init_adamw(p), p)
    # step 1: mhat = g, vhat = g^2  ->  update = lr * g/(|g|+eps)
    exp = np.array([1.0, -2.0]) - 1e-2 * np.array([0.5, 0.25]) / (
        np.abs([0.5, 0.25]) + cfg.eps)
    np.testing.assert_allclose(new_p["w"].numpy(), exp, rtol=1e-5)
    assert int(st1.step) == 1


def test_grad_clipping_bounds_update():
    cfg = AdamWConfig(clip_norm=1.0, warmup_steps=0, weight_decay=0.0)
    p = {"w": torch.zeros((4,))}
    g = {"w": torch.full((4,), 1e6)}
    _, st1, metrics = adamw_update(cfg, g, init_adamw(p), p)
    assert float(metrics["grad_norm"]) > 1e6
    # clipped first moment: |m| <= (1-b1) * clip_norm
    assert float(st1.mu["w"].abs().max()) <= 0.11


def test_lr_schedule_shape():
    cfg = AdamWConfig(peak_lr=1.0, warmup_steps=10, total_steps=110,
                      min_lr_ratio=0.1)
    lrs = [float(lr_schedule(cfg, torch.tensor(t, dtype=torch.int32)))
           for t in (0, 5, 10, 60, 110)]
    assert lrs[0] == 0.0
    assert lrs[1] == pytest.approx(0.5)
    assert lrs[2] == pytest.approx(1.0)
    assert 0.1 < lrs[3] < 1.0
    assert lrs[4] == pytest.approx(0.1, rel=1e-3)


def test_adamw_update_matches_jax_on_identical_grads():
    """Three steps from the same params, grads and moments, float32: the
    port's in-place update against ``repro.train.optimizer.adamw_update``,
    with clipping active (global norm above clip_norm), warmup and decay."""
    cfg = dict(peak_lr=1e-2, warmup_steps=2, total_steps=10,
               weight_decay=0.1, clip_norm=0.5)
    rng = np.random.default_rng(0)
    params = {"a": {"w": rng.normal(size=(5, 3)).astype(np.float32)},
              "b": rng.normal(size=(7,)).astype(np.float32)}
    mu = jax.tree.map(lambda x: rng.normal(size=x.shape).astype(np.float32)
                      * 0.1, params)
    nu = jax.tree.map(lambda x: rng.random(size=x.shape).astype(np.float32)
                      * 0.01, params)
    jp, jst = params, jopt.AdamWState(jnp.int32(3), mu, nu)
    tp = jax.tree.map(lambda x: torch.from_numpy(x.copy()), params)
    tst = AdamWState(torch.tensor(3, dtype=torch.int32),
                     jax.tree.map(lambda x: torch.from_numpy(x.copy()), mu),
                     jax.tree.map(lambda x: torch.from_numpy(x.copy()), nu))
    for _ in range(3):
        grads = jax.tree.map(
            lambda x: rng.normal(size=x.shape).astype(np.float32), params)
        jp, jst, jm = jopt.adamw_update(jopt.AdamWConfig(**cfg), grads, jst,
                                        jp)
        tp, tst, tm = adamw_update(AdamWConfig(**cfg), jax.tree.map(
            torch.from_numpy, grads), tst, tp)
        assert float(jm["grad_norm"]) > cfg["clip_norm"]
        for key in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                       rtol=1e-5)
        assert int(tst.step) == int(jst.step)
        for got, exp in ((tp, jp), (tst.mu, jst.mu), (tst.nu, jst.nu)):
            for (path, g), (_, e) in zip(tree_leaves(got),
                                         tree_leaves(_np(exp))):
                np.testing.assert_allclose(g.numpy(), e, rtol=1e-5,
                                           atol=1e-7, err_msg=path)


# ---------------------------------------------------------------- loss
def test_cross_entropy_matches_jax_with_masked_and_ignored_labels():
    rng = np.random.default_rng(1)
    logits = (rng.normal(size=(2, 9, 13)) * 3).astype(np.float32)
    labels = rng.integers(0, 13, (2, 9)).astype(np.int32)
    labels[0, :3] = -1                      # no loss there
    labels[1, 4] = int(np.argmax(logits[1, 4]))    # one sure hit
    seg = np.ones((2, 9), np.int32)
    seg[1, -2:] = 0                         # padding
    mask = ((labels >= 0) & (seg > 0)).astype(np.float32)
    exp_loss, exp_acc = jts.cross_entropy(logits, labels, mask)
    loss, acc = ts.cross_entropy(torch.from_numpy(logits),
                                 torch.from_numpy(labels),
                                 torch.from_numpy(mask))
    np.testing.assert_allclose(loss.item(), float(exp_loss), rtol=1e-6)
    np.testing.assert_allclose(acc.item(), float(exp_acc), rtol=1e-6)
    assert acc.item() > 0
    empty = torch.zeros((2, 9))             # denominator max(sum, 1)
    assert ts.cross_entropy(torch.from_numpy(logits),
                            torch.from_numpy(labels), empty)[0].item() == 0


def test_loss_and_every_grad_match_jax(setup):
    """One forward and backward of reduced qwen3 (2 layers) on a packed
    batch: the loss and every leaf's float32 gradient against
    ``jax.value_and_grad(make_loss_fn(model))`` on the same state."""
    cfg, jmodel, jstate, batch = setup
    (jtotal, jmetrics), jgrads = jax.jit(jax.value_and_grad(
        jts.make_loss_fn(jmodel), has_aux=True))(jstate.params, batch)
    model, state = train_state_from_jax(_np(jstate), cfg, "cpu")
    total, metrics = ts.make_loss_fn(model)(state.params, _tb(batch))
    total.backward()
    assert abs(total.item() - float(jtotal)) < LOSS_TOL
    assert metrics["tokens"].item() == float(jmetrics["tokens"])
    for (path, p), (_, g) in zip(tree_leaves(state.params),
                                 tree_leaves(_np(jgrads))):
        assert p.dtype == torch.float32 and p.grad.dtype == torch.float32
        assert np.abs(g).max() > 0, path
        assert _rel_l2(p.grad, g) < GRAD_REL_L2, path


def test_train_steps_match_jax(setup):
    """Three AdamW steps on one batch: the losses, and what the steps added
    to every param, against JAX's.  The update is compared by relative L2,
    not each param by an absolute tolerance: Adam's first steps move each
    weight by about lr sign(g), so a gradient near zero whose sign differs
    between XLA's and torch's bf16 arithmetic moves that weight 2 lr apart,
    and an atol that allows it would also pass params that never moved.  A
    step left out or a wrong lr gives a relative L2 of 0.5 or more, no
    update at all 1."""
    cfg, jmodel, jstate, batch = setup
    model, state = train_state_from_jax(_np(jstate), cfg, "cpu")
    before = {path: p.detach().double().numpy().copy()
              for path, p in tree_leaves(state.params)}
    jbefore = dict(tree_leaves(_np(jstate.params)))
    jstep = jax.jit(jts.make_train_step(jmodel, jopt.AdamWConfig(**OPT)))
    step = ts.make_train_step(model, AdamWConfig(**OPT))
    tbatch = _tb(batch)
    steps = 3
    for _ in range(steps):
        jstate, jm = jstep(jstate, batch)
        state, m = step(state, tbatch)
        assert abs(m["loss"].item() - float(jm["loss"])) < LOSS_TOL
        np.testing.assert_allclose(m["lr"].item(), float(jm["lr"]),
                                   rtol=1e-6)
        assert all(p.grad is None for p in model.parameters())
    assert int(state.opt.step) == steps
    for (path, p), (_, e) in zip(tree_leaves(state.params),
                                 tree_leaves(_np(jstate.params))):
        exp = np.asarray(e, np.float64) - jbefore[path]
        got = p.detach().double().numpy() - before[path]
        assert np.abs(exp).max() > 0, path
        rel = np.linalg.norm(got - exp) / np.linalg.norm(exp)
        assert rel < UPDATE_REL_L2, (path, rel)


def test_loss_decreases_tiny_model():
    """The port of tests/test_train.py::test_loss_decreases_tiny_model."""
    cfg = reduced().replace(num_layers=2)
    model = build_model(cfg, torch.Generator().manual_seed(0))
    state = ts.init_train_state(model)
    step = ts.make_train_step(model, AdamWConfig(
        peak_lr=5e-3, warmup_steps=5, total_steps=100))
    batch = _tb(make_lm_batch(cfg, 4, 64, seed=3))
    losses = []
    for _ in range(12):
        state, metrics = step(state, batch)   # memorize one batch
        losses.append(metrics["loss"].item())
    assert losses[-1] < losses[0] * 0.8, losses
    assert np.isfinite(losses).all()


def test_train_state_keeps_fp32_masters_and_serving_cannot_train(setup):
    cfg, _, jstate, _ = setup
    model, state = train_state_from_jax(_np(jstate), cfg, "cpu")
    assert all(p.requires_grad and p.dtype == torch.float32
               for p in model.parameters())
    assert int(state.opt.step) == int(jstate.opt.step)
    ts.make_prefill_step(model)       # the serve cast: bf16, in place
    with pytest.raises(ValueError, match="float32"):
        ts.init_train_state(model)
