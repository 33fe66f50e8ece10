"""The port's RWKV6 training slice vs the JAX package, on the CPU.

The WKV6 gradients: autograd of the port's ``ref.wkv6_chunked`` against
``jax.vjp`` of ``repro.models.rwkv.wkv6_chunked`` on the same numpy inputs
(resets mid-chunk, padding rows whose k is zeroed as the model zeroes it),
and the plain versions of the ``wkv6_bwd`` kernel (``ref.wkv6_bwd_ref``,
and ``ref.wkv6_bwd_two_pass``, the kernel's decomposition) against the
float64 oracle, autograd of the sequential ``ref.wkv6_ref``, at ragged
lengths (JAX's chunked form asserts ``s % chunk == 0``) and steep decays.
Tolerance: atol 5e-5, rtol 5e-4 (tests/test_kernels.py:106).

The model: reduced rwkv6-3b from one JAX state, its layer-norm affines
moved off 1 and 0 and its zero-initialised LoRA up-projections given small
random values (as tests/test_torch_rwkv.py does), so every leaf has a
gradient: the loss and every leaf's gradient against ``jax.value_and_grad``
of the JAX loss, then three train steps, at ``tests/test_torch_train.py``'s
tolerances; and the training launcher on the CPU.  The CUDA kernels are
checked on the card by ``chip_smoke.py --only rwkvtrain``.

Both sides compute in float32 here.  With the bf16 compute copy, this
model's gradients are rounding, not signal, in both frameworks:
``test_jax_bf16_rwkv_gradients_are_rounding`` measures JAX's own bf16
gradients on this state against its float32 ones, 0.22-0.58 relative L2
on the layers' leaves, ten times the tolerance a port's gradient is held
to.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import make_lm_batch
from repro.configs.rwkv6_3b import reduced as jax_reduced
from repro.models import rwkv as jrwkv
from repro.models.model_zoo import build_model as jax_build_model
from repro.train import optimizer as jopt
from repro.train import train_step as jts

from repro_torch.configs.rwkv6_3b import reduced
from repro_torch.kernels import ops, ref, wkv6, wkv6_bwd
from repro_torch.models.convert import params_from_jax, train_state_from_jax
from repro_torch.models.params import tree_leaves
from repro_torch.train import train_step as ts
from repro_torch.train.optimizer import AdamWConfig

from test_torch_train import GRAD_REL_L2, LOSS_TOL, OPT, UPDATE_REL_L2

WKV_TOL = dict(atol=5e-5, rtol=5e-4)
GRADS = ("dr", "dk", "dv", "dloga", "du")


def _inputs(b, h, s, dk, scale=0.5, pad=0):
    """tests/test_kernels.py's WKV6 inputs in the model's (b, s, h, dk)
    layout with loga = -exp(scale N(0, 1)), resets at every row's start and
    mid-chunk, and the last ``pad`` tokens of row 0 padding (a reset each,
    k zeroed); dO of the same shape."""
    rng = np.random.default_rng([b, h, s, dk, int(scale * 10), pad])
    r, k, v, dout = (rng.normal(size=(b, s, h, dk)).astype(np.float32) * 0.5
                     for _ in range(4))
    loga = -np.exp(rng.normal(size=(b, s, h, dk)).astype(np.float32)
                   * scale)
    u = rng.normal(size=(h, dk)).astype(np.float32) * 0.5
    reset = np.zeros((b, s), bool)
    reset[:, 0] = True
    reset[0, s // 3] = True
    reset[-1, s // 2 + 3] = True
    if pad:
        reset[0, s - pad:] = True
        k[0, s - pad:] = 0.0
    return r, k, v, loga, u, reset, dout


def _close(got, exp, name=""):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(exp, np.float64), err_msg=name,
                               **WKV_TOL)


def _exact(args):
    """Autograd of the sequential ``ref.wkv6_ref`` in float64."""
    t = [torch.from_numpy(a).double().requires_grad_() for a in args[:5]]
    o = ref.wkv6_ref(*t, torch.from_numpy(args[5]))
    return torch.autograd.grad(o, t, torch.from_numpy(args[6]).double())


@pytest.mark.parametrize("b,h,s,dk,chunk,pad", [
    (2, 3, 128, 32, 32, 0), (1, 2, 192, 64, 64, 0), (2, 2, 64, 16, 16, 0),
    (2, 3, 128, 32, 32, 21), (2, 2, 128, 64, 64, 40)])
def test_wkv6_chunked_grads_match_jax_vjp(b, h, s, dk, chunk, pad):
    """All five gradients of the port's chunked WKV6 (``ref.wkv6_bwd_ref``,
    autograd of ``ref.wkv6_chunked``) against ``jax.vjp`` of JAX's."""
    args = _inputs(b, h, s, dk, pad=pad)
    _, vjp = jax.vjp(lambda r, k, v, la, u: jrwkv.wkv6_chunked(
        r, k, v, la, u, chunk=chunk, reset=args[5]), *args[:5])
    exp = vjp(jnp.asarray(args[6]))
    got = ref.wkv6_bwd_ref(*map(torch.from_numpy, args), chunk=chunk)
    for name, g, e in zip(GRADS, got, exp):
        assert g.shape == e.shape and g.dtype == torch.float32, name
        _close(g.numpy(), e, name)


@pytest.mark.parametrize("s,dk,chunk", [(200, 64, 64), (40, 32, 64),
                                        (200, 16, 24)])
def test_wkv6_bwd_ref_ragged_matches_float64_oracle(s, dk, chunk):
    """At a ragged s the plain backward pads to whole chunks; it holds the
    float64 oracle's gradients."""
    args = _inputs(2, 2, s, dk, pad=9)
    got = ref.wkv6_bwd_ref(*map(torch.from_numpy, args), chunk=chunk)
    for name, g, e in zip(GRADS, got, _exact(args)):
        assert g.shape == e.shape, name
        _close(g.numpy(), e.numpy(), name)


@pytest.mark.parametrize("scale", [0.5, 1.5, 2.5])
@pytest.mark.parametrize("s,dk,chunk", [(128, 64, 64), (128, 32, 32),
                                        (128, 16, 16), (200, 64, 64),
                                        (40, 32, 64), (200, 32, 24),
                                        (130, 16, 40)])
def test_wkv6_bwd_two_pass_matches_float64_oracle(s, dk, chunk, scale):
    """The kernel's decomposition takes every decay over its own range, so
    it holds the float64 oracle at steep decays too (loga down to about
    -1e5 at scale 2.5), where autograd of the float32 ``wkv6_chunked``
    does not."""
    args = _inputs(2, 2, s, dk, scale=scale, pad=11)
    *got, dstates = ref.wkv6_bwd_two_pass(*map(torch.from_numpy, args),
                                          chunk=chunk)
    nc = -(-s // chunk)
    assert dstates.shape == (2, 2, nc, dk, dk)
    assert not dstates[:, :, -1].any()
    for name, g, e in zip(GRADS, got, _exact(args)):
        _close(g.numpy(), e.numpy(), name)


@pytest.mark.parametrize("s,chunk", [(192, 64), (150, 40), (100, 24)])
def test_wkv6_bwd_two_pass_reset_on_sub_chunk_edge(s, chunk):
    """Resets on the first token of a sub-chunk (16 and 32 tokens into a
    chunk), where a block below the diagonal is cut off whole and a
    diagonal block starts a segment, and one on a chunk's last token."""
    args = _inputs(2, 2, s, 16, scale=1.5)
    reset = args[5]
    reset[0, 16] = reset[0, chunk + 32] = reset[1, 2 * chunk - 1] = True
    *got, _ = ref.wkv6_bwd_two_pass(*map(torch.from_numpy, args),
                                    chunk=chunk)
    for name, g, e in zip(GRADS, got, _exact(args)):
        _close(g.numpy(), e.numpy(), name)


def test_wkv6_bwd_two_pass_state_gradients_match_jax():
    """The gradient of the state leaving the first chunk: the rest of the
    row sees the first chunk only through that state, so ``jax.vjp`` of
    JAX's chunked form over the first chunk alone, with that gradient as
    the final state's cotangent, gives the whole row's gradients of the
    first chunk's inputs."""
    chunk, s = 32, 128
    args = _inputs(1, 2, s, 32)
    t = list(map(torch.from_numpy, args))
    *_, dstates = ref.wkv6_bwd_two_pass(*t, chunk=chunk)
    n = chunk
    _, vjp = jax.vjp(lambda r, k, v, la, u: jrwkv.wkv6_chunked(
        r, k, v, la, u, chunk=chunk, reset=args[5][:, :n],
        return_state=True), *(a[:, :n] for a in args[:4]), args[4])
    exp = vjp((jnp.asarray(args[6][:, :n]), jnp.asarray(dstates[:, :, 0])))
    got = ref.wkv6_bwd_ref(*t, chunk=chunk)
    for name, g, e in zip(GRADS[:4], got[:4], exp[:4]):
        _close(g[:, :n].numpy(), e, name)


def test_ops_wkv6_autograd_wires_the_two_kernels(monkeypatch):
    """``ops._WKV6`` runs the forward with a chunk-states buffer and hands
    that buffer, dO and the inputs to the backward; here both kernels are
    stood in for by the plain decompositions on the CPU."""
    calls = []

    def forward(r, k, v, loga, u, reset, *, chunk, chunk_states):
        calls.append("forward")
        o, _, states = ref.wkv6_two_pass(r, k, v, loga, u, reset,
                                         chunk=chunk)
        chunk_states.copy_(states)
        return o

    def backward(r, k, v, loga, u, reset, dout, chunk_states, *, chunk):
        calls.append("backward")
        _, _, states = ref.wkv6_two_pass(r, k, v, loga, u, reset,
                                         chunk=chunk)
        assert torch.equal(chunk_states, states)
        return ref.wkv6_bwd_two_pass(r, k, v, loga, u, reset, dout,
                                     chunk=chunk)[:5]

    monkeypatch.setattr(wkv6, "wkv6", forward)
    monkeypatch.setattr(wkv6_bwd, "wkv6_bwd", backward)
    args = _inputs(2, 3, 96, 16, pad=5)
    leaves = [torch.from_numpy(a).requires_grad_() for a in args[:5]]
    out = ops._WKV6.apply(*leaves, torch.from_numpy(args[5]), 32)
    out.backward(torch.from_numpy(args[6]))
    assert calls == ["forward", "backward"]
    exp = ref.wkv6_bwd_ref(*map(torch.from_numpy, args), chunk=32)
    for name, t, e in zip(GRADS, leaves, exp):
        _close(t.grad.numpy(), e.numpy(), name)


def test_wkv6_return_state_under_grad_raises_before_any_kernel():
    """No training path asks for the final state, whose gradient the
    backward kernel does not take: off the CPU, ``ops.wkv6`` under grad
    with ``return_state`` raises and names ROADMAP.md (meta tensors: no
    card, no kernel)."""
    x = torch.zeros((1, 8, 2, 16), device="meta", requires_grad=True)
    reset = torch.ones((1, 8), dtype=torch.bool, device="meta")
    u = torch.zeros((2, 16), device="meta")
    before = (wkv6.launches, wkv6_bwd.launches)
    with pytest.raises(RuntimeError, match="ROADMAP.md"):
        ops.wkv6(x, x, x, x, u, reset, chunk=16, return_state=True)
    assert (wkv6.launches, wkv6_bwd.launches) == before


def test_wkv6_bwd_wrapper_refuses_cpu_tensors():
    """No fallback: the backward wrapper launches on CUDA tensors or
    raises."""
    x = torch.zeros((1, 8, 2, 16))
    reset = torch.ones((1, 8), dtype=torch.bool)
    states = torch.zeros((1, 2, 1, 16, 16))
    before = wkv6_bwd.launches
    with pytest.raises(ValueError, match="CUDA"):
        wkv6_bwd.wkv6_bwd(x, x, x, x, torch.zeros((2, 16)), reset, x, states,
                          chunk=16)
    assert wkv6_bwd.launches == before


# --------------------------------------------------- reduced rwkv6-3b
@pytest.fixture(scope="module")
def setup():
    """One JAX train state of reduced rwkv6-3b with every leaf live, its
    numpy copy, and a packed batch with padding."""
    cfg = reduced()
    jmodel = jax_build_model(jax_reduced())
    jstate = jts.init_train_state(jmodel, jax.random.key(0))
    rng = np.random.default_rng(0)

    def perturb(tree):
        out = {}
        for k, v in tree.items():
            v = v if isinstance(v, dict) else np.asarray(v)
            if isinstance(v, dict):
                out[k] = perturb(v)
            elif k in ("scale", "bias"):
                out[k] = v + rng.normal(size=v.shape).astype(np.float32) * 0.3
            elif k.startswith("mixB_") or k == "loraB_w":
                out[k] = rng.normal(size=v.shape).astype(np.float32) * 0.1
            else:
                out[k] = v
        return out

    params = jax.tree.map(jnp.asarray, perturb(jstate.params))
    jstate = jts.TrainState(params, jopt.init_adamw(params))
    batch = make_lm_batch(cfg, 2, 64, seed=0)
    return cfg, jmodel, jstate, batch


def _tb(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


@pytest.fixture
def float32_compute(monkeypatch):
    """Both frameworks' train steps compute on the float32 masters instead
    of a bf16 copy (the module docstring says why)."""
    monkeypatch.setattr(jts, "_cast_for_compute",
                        lambda params, compute_dtype=None: params)
    monkeypatch.setattr(ts, "COMPUTE_DTYPE", torch.float32)


def test_jax_bf16_rwkv_gradients_are_rounding(setup):
    """Why this file holds RWKV6 training in float32: within JAX alone, the
    train loss's gradients through the bf16 compute copy lie far from the
    same loss's gradients on the float32 weights (every layer leaf past 3x
    GRAD_REL_L2, the worst past 10x), while the final norm and unembedding,
    before the recurrence, agree; the losses agree to LOSS_TOL."""
    cfg, jmodel, jstate, batch = setup

    def f32_loss(params):
        logits, _ = jmodel.forward(params, batch)
        mask = ((batch["labels"] >= 0) & (batch["segment_ids"] > 0)
                ).astype(jnp.float32)
        return jts.cross_entropy(logits, batch["labels"], mask)[0]
    (bf_loss, _), bf = jax.jit(jax.value_and_grad(
        jts.make_loss_fn(jmodel), has_aux=True))(jstate.params, batch)
    f32, f32_grads = jax.jit(jax.value_and_grad(f32_loss))(jstate.params)
    assert abs(float(bf_loss) - float(f32)) < LOSS_TOL
    rel = {}
    for (path, g), (_, e) in zip(tree_leaves(jax.tree.map(np.asarray, bf)),
                                 tree_leaves(jax.tree.map(np.asarray,
                                                          f32_grads))):
        g, e = np.asarray(g, np.float64), np.asarray(e, np.float64)
        rel[path] = np.linalg.norm(g - e) / np.linalg.norm(e)
    layers = {p: r for p, r in rel.items() if p.startswith("layers.")}
    assert min(layers.values()) > 3 * GRAD_REL_L2, layers
    assert max(layers.values()) > 10 * GRAD_REL_L2, layers
    assert rel["unembed"] < GRAD_REL_L2 and rel["final_norm.scale"] \
        < GRAD_REL_L2, rel


def test_rwkv_loss_and_every_grad_match_jax_in_float32(setup):
    """The masked cross-entropy of the float32 model and every leaf's
    gradient against ``jax.value_and_grad`` of the same loss."""
    cfg, jmodel, jstate, batch = setup

    def jloss(params):
        logits, _ = jmodel.forward(params, batch)
        mask = ((batch["labels"] >= 0) & (batch["segment_ids"] > 0)
                ).astype(jnp.float32)
        return jts.cross_entropy(logits, batch["labels"], mask)[0]
    jtotal, jgrads = jax.jit(jax.value_and_grad(jloss))(jstate.params)
    model = params_from_jax(jax.tree.map(np.asarray, jstate.params), cfg,
                            "cpu")
    model.requires_grad_(True)
    tb = _tb(batch)
    logits, _ = model(tb)
    mask = ((tb["labels"] >= 0) & (tb["segment_ids"] > 0)).float()
    total = ts.cross_entropy(logits, tb["labels"], mask)[0]
    total.backward()
    assert abs(total.item() - float(jtotal)) < LOSS_TOL
    paths = []
    for (path, p), (_, g) in zip(tree_leaves(model.tree()),
                                 tree_leaves(jax.tree.map(np.asarray,
                                                          jgrads))):
        g = np.asarray(g, np.float64)
        assert np.abs(g).max() > 0, path
        rel = np.linalg.norm(p.grad.double().numpy() - g) / np.linalg.norm(g)
        assert rel < GRAD_REL_L2, (path, rel)
        paths.append(path)
    assert "layers.tm.u" in paths and "layers.tm.loraA_w" in paths


def test_rwkv_train_steps_match_jax_in_float32(setup, float32_compute):
    """Three AdamW steps from one state, both computing in float32: each
    step's loss and gradient norm, and what the steps added to each
    leaf."""
    cfg, jmodel, jstate, batch = setup
    model, state = train_state_from_jax(jax.tree.map(np.asarray, jstate),
                                        cfg, "cpu")
    before = dict(tree_leaves(jax.tree.map(np.asarray, jstate.params)))
    jstep = jax.jit(jts.make_train_step(jmodel, jopt.AdamWConfig(**OPT)))
    step = ts.make_train_step(model, AdamWConfig(**OPT))
    for _ in range(3):
        jstate, jm = jstep(jstate, batch)
        state, m = step(state, _tb(batch))
        assert abs(m["loss"].item() - float(jm["loss"])) < LOSS_TOL
        assert abs(m["grad_norm"].item() - float(jm["grad_norm"])) \
            < GRAD_REL_L2 * float(jm["grad_norm"])
    for (path, p), (_, e) in zip(tree_leaves(state.params),
                                 tree_leaves(jax.tree.map(np.asarray,
                                                          jstate.params))):
        exp = np.asarray(e, np.float64) - before[path]
        assert np.abs(exp).max() > 0, path
        got = p.detach().double().numpy() - before[path]
        rel = np.linalg.norm(got - exp) / np.linalg.norm(exp)
        assert rel < UPDATE_REL_L2, (path, rel)


def test_launcher_trains_rwkv_on_the_cpu():
    from repro_torch.launch import train
    out = train.main(["--arch", "rwkv6-3b", "--reduced", "--device", "cpu",
                      "--steps", "3", "--seq-len", "128"])
    hist = out["history"]
    assert len(hist) == 3 and np.isfinite([r["loss"] for r in hist]).all()
    assert out["trainer"].model.cfg.family == "ssm"
