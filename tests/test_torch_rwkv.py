"""The port's RWKV6 serving slice vs the JAX package on reduced rwkv6-3b.

JAX draws the weights (``init_params(key(0), float32)``).  Then, in numpy,
the layer-norm scales and biases are moved away from 1 and 0 (unit scales
would hide a wrong bf16 cast, since bf16(1.0) is exact), and the
zero-initialised LoRA up-projections (``mixB_*``, ``loraB_w``) get small
random values, so that the data-dependent mix and decay are exercised
rather than multiplied by zero.  The same numpy tree goes to JAX and,
through ``params_from_jax``, to the port, on the CPU, where the WKV runs
the plain chunked version.  float32 logits and states agree to
atol = rtol = 2e-3, the tolerance of tests/test_models.py.
"""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from conftest import make_lm_batch
from repro.configs.rwkv6_3b import reduced as jax_reduced
from repro.models.model_zoo import build_model as jax_build_model
from repro.train import train_step as jax_train_step

from repro_torch.configs import get_config
from repro_torch.configs.rwkv6_3b import reduced
from repro_torch.kernels import ops
from repro_torch.launch import serve
from repro_torch.models.convert import params_from_jax
from repro_torch.models.model_zoo import model_defs
from repro_torch.models.params import param_count, tree_leaves
from repro_torch.train.train_step import make_decode_step, make_prefill_step

F32_TOL = dict(atol=2e-3, rtol=2e-3)
# The tolerance of tests/test_torch_serve.py, with its reason: bf16 weights
# and activations, and the two frameworks round matmul outputs and the
# elementwise mixes at different places, so logits (|x| < ~5 here) differ
# by a bf16 ulp or two: 2^-5 = 0.031 at |x| in [4, 8).
BF16_TOL = dict(atol=3e-2, rtol=3e-2)


@pytest.fixture(scope="module")
def setup():
    cfg, jcfg = reduced(), jax_reduced()
    jmodel = jax_build_model(jcfg)
    np_tree = jax.tree.map(np.asarray, jmodel.init(jax.random.key(0),
                                                   jnp.float32))
    rng = np.random.default_rng(0)

    def perturb(tree):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = perturb(v)
            elif k in ("scale", "bias"):
                out[k] = v + rng.normal(size=v.shape).astype(np.float32) * 0.3
            elif k.startswith("mixB_") or k == "loraB_w":
                out[k] = rng.normal(size=v.shape).astype(np.float32) * 0.1
            else:
                out[k] = v
        return out

    np_tree = perturb(np_tree)
    jparams = jax.tree.map(jnp.asarray, np_tree)
    return cfg, jmodel, jparams, np_tree


def _tb(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def _close(got: torch.Tensor, exp, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(exp, np.float32), **tol)


def test_full_width_rwkv6_3b_shapes_and_param_count():
    cfg = get_config("rwkv6-3b")
    assert (cfg.num_layers, cfg.d_model, cfg.d_ff, cfg.vocab_size,
            cfg.rwkv_head_dim, cfg.rwkv_chunk, cfg.rwkv_lora_dim) == (
        32, 2560, 8960, 65_536, 64, 64, 64)
    defs = model_defs(cfg)
    assert param_count(defs) == 3_099_703_296
    assert defs["layers"]["tm"]["u"].shape == (32, 40, 64)
    # the mix LoRAs are 32 wide, only the decay LoRA is rwkv_lora_dim wide
    assert defs["layers"]["tm"]["mixA_r"].shape == (32, 2560, 32)
    assert defs["layers"]["tm"]["loraA_w"].shape == (32, 2560, 64)


def test_params_from_jax_is_strict(setup):
    cfg, _, _, np_tree = setup
    model = params_from_jax(np_tree, cfg, "cpu")
    assert set(model.state_dict()) == {p for p, _ in tree_leaves(np_tree)}
    assert model.state_dict()["layers.tm.u"].shape == (2, 4, 16)
    missing = {k: v for k, v in np_tree.items() if k != "ln0"}
    with pytest.raises(RuntimeError, match="Missing key"):
        params_from_jax(missing, cfg, "cpu")


def test_forward_matches_jax_on_packed_batch(setup):
    """Three segments per row (resets mid-chunk at 19 and 39) and trailing
    padding; s = 64 is four chunks of 16."""
    cfg, jmodel, jparams, np_tree = setup
    batch = make_lm_batch(cfg, 2, 64, n_segments=3, trailing_pad=5)
    assert (batch["segment_ids"][:, -1] == 0).all()
    exp, _ = jax.jit(jmodel.forward)(jparams, batch)
    with torch.no_grad():
        got, aux = params_from_jax(np_tree, cfg, "cpu")(_tb(batch))
    assert got.shape == (2, 64, cfg.vocab_size) and float(aux) == 0.0
    _close(got, exp, F32_TOL)


def test_prefill_logits_and_states_match_jax(setup):
    """Prefill of a packed row with padding at its end: the shift states
    are taken at the row's last position, padding or not, as in JAX."""
    cfg, jmodel, jparams, np_tree = setup
    batch = make_lm_batch(cfg, 2, 32, n_segments=2, trailing_pad=4)
    exp_logits, exp_states = jax.jit(jmodel.prefill)(jparams, batch)
    with torch.no_grad():
        got_logits, got_states = params_from_jax(
            np_tree, cfg, "cpu").prefill(_tb(batch))
    assert got_logits.shape == (2, 1, cfg.vocab_size)
    _close(got_logits, exp_logits, F32_TOL)
    assert set(got_states) == set(exp_states) == {"tm_shift", "cm_shift",
                                                  "wkv"}
    for n in ("tm_shift", "cm_shift", "wkv"):
        assert got_states[n].shape == exp_states[n].shape, n
        _close(got_states[n], exp_states[n], F32_TOL)


def test_decode_replay_and_greedy_match_jax(setup):
    """16 prompt tokens replayed through decode_step, then greedy decode;
    logits agree at every step, the greedy tokens are equal, and so are
    the final states."""
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
    for n in ("tm_shift", "cm_shift", "wkv"):
        assert cache[n].dtype == torch.float32
        _close(cache[n], jcache[n], F32_TOL)


def test_bf16_serve_path_matches_jax(setup):
    """make_prefill_step / make_decode_step cast like JAX's
    ``_cast_for_compute``: every float32 leaf of rank > 1 (the stacked u,
    w0, mu_* and per-layer LN scales included) to bf16; ``ln0`` and
    ``final_norm`` kept in float32.  The cast leaves are compared exactly,
    then the prefill logits and the logits of a prompt replay on a float32
    cache."""
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
    for path in ("layers.tm.u", "layers.tm.w0", "layers.tm.mu_r",
                 "layers.tm.ln.scale", "layers.tm.out_ln.bias"):
        assert state[path].dtype == torch.bfloat16, path
    assert state["ln0.scale"].dtype == torch.float32
    assert state["final_norm.bias"].dtype == torch.float32

    b, s = 2, 16
    batch = make_lm_batch(cfg, b, s, n_segments=1, trailing_pad=0)
    exp, exp_states = jax.jit(jax_train_step.make_prefill_step(jmodel))(
        jparams, batch)
    got, got_states = prefill(_tb(batch))
    assert got.dtype == torch.bfloat16
    assert got_states["tm_shift"].dtype == torch.bfloat16
    assert got_states["wkv"].dtype == torch.float32
    _close(got, exp, BF16_TOL)

    jdecode = jax.jit(jax_train_step.make_decode_step(jmodel))
    jcache = jmodel.init_cache(b, s, jnp.float32)
    cache = model.init_cache(b, s, torch.float32)
    for t in range(s):
        jlogits, jcache = jdecode(jparams, jcache,
                                  batch["tokens"][:, t:t + 1], jnp.int32(t))
        logits, cache = decode(cache, _tb(batch)["tokens"][:, t:t + 1], t)
    _close(logits, jlogits, BF16_TOL)


def test_wkv_state_stops_at_resets_but_token_shift_crosses(setup):
    """The WKV state does not cross a segment start: segment 2's WKV output
    is the same whatever segment 1's r, k, v and decays were.  The token
    shift does cross it (the reference's contract: in every layer the first
    token of segment 2 mixes in the previous position's activations), so
    segment 2's logits do depend on segment 1."""
    cfg, _, _, np_tree = setup
    rng = np.random.default_rng(0)
    b, s, h, dk = 1, 64, 4, 16
    seg = np.zeros((b, s), np.int32)
    seg[0, :24], seg[0, 24:54] = 1, 2
    tseg = torch.from_numpy(seg)
    prev = torch.nn.functional.pad(tseg[:, :-1], (1, 0))
    reset = (tseg != prev) | (tseg == 0)
    r, k, v, w = (torch.from_numpy(rng.normal(size=(b, s, h, dk)).astype(
        np.float32)) for _ in range(4))
    u = torch.from_numpy(rng.normal(size=(h, dk)).astype(np.float32))
    o1 = ops.wkv6(r, k, v, -torch.exp(w), u, reset, chunk=16)
    r2, k2, v2, w2 = (x.clone() for x in (r, k, v, w))
    for x in (r2, k2, v2, w2):
        x[:, :24] = torch.from_numpy(rng.normal(size=(b, 24, h, dk)).astype(
            np.float32))
    o2 = ops.wkv6(r2, k2, v2, -torch.exp(w2), u, reset, chunk=16)
    assert not torch.allclose(o1[:, :24], o2[:, :24])
    # equal up to rounding, at the WKV tolerance of tests/test_kernels.py:
    # segment 1's decays still sit in the chunk's cumsum, and cancel from
    # segment 2's decay differences only to float32 rounding
    torch.testing.assert_close(o1[:, 24:], o2[:, 24:], atol=5e-5, rtol=5e-4)

    model = params_from_jax(np_tree, cfg, "cpu")
    tokens = rng.integers(1, cfg.vocab_size, (2, s)).astype(np.int32)
    tokens[1, 24:54] = tokens[0, 24:54]
    with torch.no_grad():
        logits, _ = model(_tb(dict(tokens=tokens,
                                   segment_ids=np.repeat(seg, 2, 0))))
    assert not torch.allclose(logits[0, 24:54], logits[1, 24:54])


def test_serve_main_on_cpu_returns_tokens():
    out = serve.main(["--arch", "rwkv6-3b", "--reduced", "--device", "cpu",
                      "--batch", "2", "--prompt-len", "16", "--gen", "4"])
    assert out["tokens"].shape == (2, 4)
    assert ((out["tokens"] >= 0) & (out["tokens"] < reduced().vocab_size)
            ).all()
    assert torch.isfinite(out["logits"].float()).all()
    assert torch.isfinite(out["prefill_logits"].float()).all()
