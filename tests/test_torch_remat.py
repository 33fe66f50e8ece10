"""The reference's rematerialisation policy, ``cfg.remat``, in the port's
six training families, on the CPU.

``models.remat`` checkpoints each layer as the JAX package does
(``jax.checkpoint`` per layer in ``models/transformer.py``, ``hybrid.py``,
``rwkv_model.py`` and ``encdec.py``): ``"layer"`` keeps nothing of a layer,
``"dots_saveable"`` keeps its matmul outputs (transformer families only;
the other three checkpoint whole layers for any value but ``"none"``).
Recomputing a layer on the CPU runs the same ops on the same inputs, so the
three policies must agree to float32 rounding: gradients and three AdamW
steps within a relative L2 of 1e-6 a leaf.  Against JAX at its own default
(``"layer"``), the port under ``"layer"`` holds
``tests/test_torch_train.py``'s tolerances, both sides computing in
float32 (in bf16 the hybrid's and RWKV6's gradients are rounding within
JAX alone: ``tests/test_torch_hybrid.py``, ``tests/test_torch_rwkv_train.py``).
Serving never checkpoints: the prefill and decode steps record nothing for
autograd and call no checkpoint.
"""
import importlib

import jax
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from conftest import make_lm_batch
from repro.models.model_zoo import build_model as jax_build_model
from repro.train import train_step as jts

from repro_torch.models import remat
from repro_torch.models.convert import train_state_from_jax
from repro_torch.models.model_zoo import build_model
from repro_torch.models.params import tree_leaves
from repro_torch.train import train_step as ts
from repro_torch.train.optimizer import AdamWConfig

from test_torch_train import GRAD_REL_L2, LOSS_TOL, OPT

POLICY_REL_L2 = 1e-6
FAMILIES = {"dense": "qwen3_8b", "moe": "granite_moe_3b_a800m",
            "vlm": "pixtral_12b", "rwkv": "rwkv6_3b", "hybrid": "zamba2_7b",
            "audio": "whisper_medium"}
HYBRID_LAYERS = 5   # two blocks of 2 and a tail of 1 (not checkpointed)


def _cfg(pkg: str, family: str):
    cfg = importlib.import_module(
        f"{pkg}.configs.{FAMILIES[family]}").reduced()
    if family == "hybrid":
        cfg = cfg.replace(num_layers=HYBRID_LAYERS)
    return cfg


def _batch(cfg, seed=0) -> dict:
    batch = {k: torch.from_numpy(np.asarray(v))
             for k, v in make_lm_batch(cfg, 2, 64, seed=seed).items()}
    if "enc_embeds" in batch:      # the frames the card trains on
        batch["enc_embeds"] = batch["enc_embeds"].to(torch.bfloat16)
    return batch


def _checkpoints(cfg) -> int:
    """The checkpoints one training forward makes under a policy other
    than ``"none"``: one a layer, one a hybrid block, one an encoder and
    one a decoder layer."""
    if cfg.family == "hybrid":
        return cfg.num_layers // cfg.attn_every
    return cfg.num_layers + cfg.encoder_layers


def _rel_l2(got: torch.Tensor, exp: torch.Tensor) -> float:
    got, exp = got.detach().double(), exp.detach().double()
    return float(torch.linalg.norm(got - exp)
                 / max(float(torch.linalg.norm(exp)), 1e-30))


@pytest.fixture
def count_checkpoints(monkeypatch):
    calls = []
    inner = remat.checkpoint

    def counted(*args, **kw):
        calls.append(kw.get("context_fn") is not None)
        return inner(*args, **kw)
    monkeypatch.setattr(remat, "checkpoint", counted)
    return calls


def _grads_and_steps(cfg, policy: str):
    """(loss, every leaf's gradient, each of three steps' loss, the params
    after them) of the model drawn from seed 0 under ``policy``."""
    model = build_model(cfg.replace(remat=policy),
                        torch.Generator().manual_seed(0))
    state = ts.init_train_state(model)
    batch = _batch(cfg)
    total, _ = ts.make_loss_fn(model)(state.params, batch)
    total.backward()
    grads = {path: p.grad.clone() for path, p in tree_leaves(state.params)}
    model.zero_grad(set_to_none=True)
    step = ts.make_train_step(model, AdamWConfig(**OPT))
    losses = []
    for _ in range(3):
        state, m = step(state, batch)
        losses.append(m["loss"].item())
    return total.item(), grads, losses, {
        path: p.detach().clone() for path, p in tree_leaves(state.params)}


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_policies_agree_on_gradients_and_three_steps(family,
                                                     count_checkpoints):
    cfg = _cfg("repro_torch", family)
    assert cfg.remat == "layer"            # the reference's default
    loss, grads, losses, params = _grads_and_steps(cfg, "none")
    assert not count_checkpoints
    for policy in ("layer", "dots_saveable"):
        count_checkpoints.clear()
        got_loss, got_grads, got_losses, got_params = _grads_and_steps(
            cfg, policy)
        # one forward for the gradients, three for the steps
        assert len(count_checkpoints) == 4 * _checkpoints(cfg)
        selective = policy == "dots_saveable" and cfg.family in (
            "dense", "moe", "vlm")
        assert set(count_checkpoints) == {selective}
        assert got_loss == pytest.approx(loss, rel=POLICY_REL_L2)
        assert got_losses == pytest.approx(losses, rel=POLICY_REL_L2)
        for path, g in grads.items():
            assert float(g.abs().max()) > 0 or family == "rwkv", path
            assert _rel_l2(got_grads[path], g) <= POLICY_REL_L2, \
                (policy, path)
            assert _rel_l2(got_params[path], params[path]) \
                <= POLICY_REL_L2, (policy, path)


class _CountOps(TorchDispatchMode):
    """Counts the aten ops that run under it, by overload packet."""

    def __init__(self):
        super().__init__()
        self.counts = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        key = func.overloadpacket.__name__
        self.counts[key] = self.counts.get(key, 0) + 1
        return func(*args, **(kwargs or {}))


def test_dots_saveable_keeps_the_matmuls_and_recomputes_the_rest():
    """What each policy runs again in the backward of reduced qwen3-8b:
    ``"layer"`` its matmuls and the rest of the layer, ``"dots_saveable"``
    no matmul (they come from the forward) but the elementwise ops and
    norms, ``"none"`` neither."""
    cfg = _cfg("repro_torch", "dense")
    batch = _batch(cfg)
    backward = {}
    for policy in remat.POLICIES:
        model = build_model(cfg.replace(remat=policy),
                            torch.Generator().manual_seed(0))
        state = ts.init_train_state(model)
        total, _ = ts.make_loss_fn(model)(state.params, batch)
        with _CountOps() as ops:
            total.backward()
        backward[policy] = ops.counts

    def dots(counts):
        return sum(counts.get(k, 0) for k in ("mm", "addmm", "bmm"))
    assert dots(backward["dots_saveable"]) == dots(backward["none"])
    assert dots(backward["layer"]) > dots(backward["none"])
    for op in ("rsqrt", "silu"):
        assert backward["none"].get(op, 0) == 0, op
        assert backward["layer"].get(op, 0) \
            == backward["dots_saveable"].get(op, 0) > 0, op


def test_unknown_policy_raises():
    with pytest.raises(ValueError, match="unknown remat policy"):
        remat.remat(lambda h: h, "selective")
    assert remat.whole_layer("dots_saveable") == "layer"
    assert remat.whole_layer("none") == "none"


@pytest.fixture
def float32_compute(monkeypatch):
    """Both frameworks' losses on the float32 masters instead of a bf16
    copy (the module docstring says why)."""
    monkeypatch.setattr(jts, "_cast_for_compute",
                        lambda params, compute_dtype=None: params)
    monkeypatch.setattr(ts, "COMPUTE_DTYPE", torch.float32)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_layer_policy_matches_jax_at_its_default(family, float32_compute,
                                                 count_checkpoints):
    """One forward and backward from one JAX train state, the port under
    ``"layer"`` and JAX at its own default: the loss and every leaf's
    gradient at ``tests/test_torch_train.py``'s tolerances."""
    cfg, jcfg = _cfg("repro_torch", family), _cfg("repro", family)
    assert cfg.remat == jcfg.remat == "layer"
    jmodel = jax_build_model(jcfg)
    jstate = jts.init_train_state(jmodel, jax.random.key(0))
    batch = make_lm_batch(cfg, 2, 64, seed=0)
    (jtotal, _), jgrads = jax.jit(jax.value_and_grad(
        jts.make_loss_fn(jmodel), has_aux=True))(jstate.params, batch)
    model, state = train_state_from_jax(jax.tree.map(np.asarray, jstate),
                                        cfg, "cpu")
    total, _ = ts.make_loss_fn(model)(
        state.params, {k: torch.from_numpy(np.asarray(v))
                       for k, v in batch.items()})
    total.backward()
    assert len(count_checkpoints) == _checkpoints(cfg)
    assert abs(total.item() - float(jtotal)) < LOSS_TOL
    for (path, p), (_, g) in zip(tree_leaves(state.params),
                                 tree_leaves(jax.tree.map(np.asarray,
                                                          jgrads))):
        g = np.asarray(g, np.float64)
        got = p.grad.double().numpy()
        if not np.abs(g).max():        # RWKV6's zero-initialised LoRA legs
            assert np.abs(got).max() < 1e-7, path
            continue
        rel = np.linalg.norm(got - g) / np.linalg.norm(g)
        assert rel < GRAD_REL_L2, (path, rel)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_serving_records_nothing_for_autograd(family, count_checkpoints):
    """Under the default ``"layer"``, the serve steps' prefill and decode
    (``train_step.make_prefill_step``/``make_decode_step``) call no
    checkpoint and return tensors outside autograd, as does a training
    forward run without grad."""
    cfg = _cfg("repro_torch", family)
    model = build_model(cfg, torch.Generator().manual_seed(0))
    model.requires_grad_(True)
    batch = _batch(cfg)
    with torch.no_grad():
        logits, _ = model(batch)
    assert logits.grad_fn is None and not count_checkpoints
    prefill = ts.make_prefill_step(model)
    decode = ts.make_decode_step(model)
    batch = {k: v[:, :16] for k, v in batch.items()
             if k in ("tokens", "segment_ids", "positions")}
    if family == "vlm":
        batch["image_embeds"] = torch.zeros((2, 4, cfg.d_model))
        batch["image_positions"] = torch.arange(4).expand(2, 4) * 2
    if family == "audio":
        batch["enc_embeds"] = torch.zeros(
            (2, cfg.encoder_frames, cfg.d_model))
    logits, pcache = prefill(batch)
    assert logits.grad_fn is None and not logits.requires_grad
    cache = model.init_cache(2, 24)
    if family == "audio":
        cache["cross_k"], cache["cross_v"] = pcache["cross_k"], \
            pcache["cross_v"]
    logits, cache = decode(cache, batch["tokens"][:, -1:], 16)
    assert logits.grad_fn is None and not logits.requires_grad
    assert all(t.grad_fn is None for t in cache.values()
               if isinstance(t, torch.Tensor))
    assert not count_checkpoints
