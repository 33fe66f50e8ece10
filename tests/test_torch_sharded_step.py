"""The sharded step on a (2, 2) ("data", "model") mesh of 4 gloo ranks.

One spawn of 4 CPU processes (this file run as a script, one process a
rank) runs, on DTensors placed by the rules: for each family's reduced
config, the loss, every gradient and one AdamW step in float32 (the
compute cast off: ``train_step.COMPUTE_DTYPE`` float32), under the remat
policy ``"layer"`` and, for the dense config, ``"dots_saveable"``;
reduced qwen3-8b's loss and gradients in bf16 compute on JAX's weights;
and reduced qwen3-8b's prefill and four decode steps under
``DECODE_RULES``, whose cache is sharded over its sequence, in float32.
Then the KV-sequence-parallel decode (``kernels.ops``: each rank's partial
on its cache shard, merged by all-reduces): decode steps at positions
``SPREAD`` (so every shard holds live positions, some written, some zero)
of reduced qwen3-8b under ``DECODE_RULES`` (the sequence over ``model``)
and of reduced zamba2-7b at batch 1 under ``LONG_DECODE_RULES`` (over
``data`` and ``model``), each under ``launch.collectives.count``.  Rank 0
saves every result (``full_tensor()``).  The test process runs the same
steps unsharded and, for the bf16 case, JAX's step
(``tests/test_torch_train.py``'s setup).

Tolerances: sharded against unsharded, float32, 1e-5 (rtol and atol); the
sums over a sharded dim run in another order, nothing else differs.
Against JAX, bf16: ``tests/test_torch_train.py``'s loss 2e-3 and relative
L2 3e-2 a leaf.
"""
import importlib
import os
import pathlib
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
FAMILIES = {"dense": "qwen3_8b", "moe": "qwen3_moe_30b_a3b",
            "vlm": "pixtral_12b", "hybrid": "zamba2_7b",
            "audio": "whisper_medium", "ssm": "rwkv6_3b"}
# the train step's cases: each family under its default remat policy
# ("layer"), and the dense one under "dots_saveable" too
CASES = {**{f: (f, "layer") for f in FAMILIES},
         "dense-dots_saveable": ("dense", "dots_saveable")}
B, S = 2, 64
DECODE_STEPS = 4
# the sequence-parallel decode's positions: on a cache of S split in 2
# (qwen3-8b) or 4 (zamba2-7b) pieces, each piece holds one at least, or
# zero rows below one
SPREAD = (0, 1, 21, 40, S - 1)
SEQ_CASES = {"dense": ("DECODE_RULES", B), "hybrid": ("LONG_DECODE_RULES", 1)}
TOL = 1e-5
LOSS_TOL = 2e-3           # tests/test_torch_train.py
GRAD_REL_L2 = 3e-2


def _cfg(family, remat="layer"):
    return importlib.import_module(
        f"repro_torch.configs.{FAMILIES[family]}").reduced().replace(
            remat=remat)


def _batch(cfg, b: int = B) -> dict:
    sys.path.insert(0, str(ROOT / "tests"))
    from conftest import make_lm_batch
    return {k: torch.from_numpy(np.asarray(v))
            for k, v in make_lm_batch(cfg, b, S, seed=0).items()}


def _model(cfg, jax_params=None):
    from repro_torch.models.convert import params_from_jax
    from repro_torch.models.model_zoo import build_model
    if jax_params is not None:
        return params_from_jax(jax_params, cfg, "cpu")
    return build_model(cfg, torch.Generator().manual_seed(0))


def _full(t):
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def _loss_grads_step(model, batch):
    """(loss, {leaf: grad}, {leaf: param after one AdamW step})."""
    from repro_torch.models.params import tree_leaves
    from repro_torch.train import train_step as ts
    state = ts.init_train_state(model)
    total, _ = ts.make_loss_fn(model)(state.params, batch)
    total.backward()
    grads = {p: _full(t.grad).detach().clone()
             for p, t in tree_leaves(state.params)}
    for _, t in tree_leaves(state.params):
        t.grad = None
    state, _ = ts.make_train_step(model)(state, batch)
    after = {p: _full(t).detach().clone()
             for p, t in tree_leaves(state.params)}
    return _full(total).item(), grads, after


def _serve(model, cfg, batch):
    """(prefill logits, the logits of ``DECODE_STEPS`` decode steps that
    replay the prompt into an empty float32 cache)."""
    from repro_torch.train import train_step as ts
    logits, _ = ts.make_prefill_step(model)(batch)
    cache = model.init_cache(B, S, torch.float32)
    return _full(logits), cache


def _decode(model, cache, batch):
    from repro_torch.train import train_step as ts
    step = ts.make_decode_step(model)
    out = []
    for t in range(DECODE_STEPS):
        logits, cache = step(cache, batch["tokens"][:, t:t + 1], t)
        out.append(_full(logits))
    return torch.stack(out)


def _decode_spread(model, cache, tokens):
    """The logits of decode steps at ``SPREAD`` (token t at position
    SPREAD[t]) on ``cache``."""
    from repro_torch.train import train_step as ts
    step = ts.make_decode_step(model)
    out = []
    for t, pos in enumerate(SPREAD):
        logits, cache = step(cache, tokens[:, t:t + 1], pos)
        out.append(_full(logits))
    return torch.stack(out)


def _float32(monkeypatch_like):
    """Switch the compute cast off (float32 throughout)."""
    from repro_torch.train import train_step as ts
    monkeypatch_like(ts, "COMPUTE_DTYPE", torch.float32)
    monkeypatch_like(ts, "_cast_for_compute", lambda m: m)


# ------------------------------------------------------------ the ranks
def _rank_main(rank: int, port: int, out: str) -> None:
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    from repro_torch.models.model_zoo import (
        batch_logical_axes, distribute_model,
    )
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.sharding import logical as lg
    from repro_torch.train import train_step as ts

    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=4)
    mesh = DeviceMesh("cpu", torch.arange(4).reshape(2, 2),
                      mesh_dim_names=("data", "model"))
    res = {}
    train = ShapeConfig("t", "train", S, B)

    def place(model, cfg, batch, mapping, shape=train):
        distribute_model(model, mesh, mapping)
        rules = lg.ShardingRules(mesh, mapping)
        axes = batch_logical_axes(cfg, shape)
        return lg.distribute_tree({k: batch[k] for k in axes}, axes, rules)

    jax_params = torch.load(pathlib.Path(out) / "jax_params.pt",
                            weights_only=False)
    cfg = _cfg("dense")
    model = _model(cfg, jax_params)
    with lg.use_rules(mesh, lg.TRAIN_RULES):
        batch = place(model, cfg, _batch(cfg), lg.TRAIN_RULES)
        res["bf16"] = _loss_grads_step(model, batch)[:2]

    _float32(setattr)
    for case, (family, remat) in CASES.items():
        cfg = _cfg(family, remat)
        model = _model(cfg)
        with lg.use_rules(mesh, lg.TRAIN_RULES):
            batch = place(model, cfg, _batch(cfg), lg.TRAIN_RULES)
            res[case] = _loss_grads_step(model, batch)

    cfg = _cfg("dense")
    model = _model(cfg)
    full = _batch(cfg)
    with lg.use_rules(mesh, lg.DECODE_RULES) as rules:
        prompt = place(model, cfg, full, lg.DECODE_RULES,
                         ShapeConfig("p", "prefill", S, B))
        logits, cache = _serve(model, cfg, prompt)
        cache = lg.distribute_tree(cache, model.cache_axes(), rules)
        placed = [c.placements for c in cache.values()]
        tokens = lg.distribute(full["tokens"],
                               rules.spec(("batch", None), (B, S)), mesh)
        res["serve"] = (logits, _decode(model, cache, {"tokens": tokens}),
                        [str(p) for p in placed])

    from repro_torch.launch import collectives
    for family, (mapping, b) in SEQ_CASES.items():
        cfg = _cfg(family)
        model = _model(cfg)
        mapping = getattr(lg, mapping)
        with lg.use_rules(mesh, mapping) as rules:
            distribute_model(model, mesh, mapping)
            cache = lg.distribute_tree(
                model.init_cache(b, S, torch.float32), model.cache_axes(),
                rules)
            tokens = lg.distribute(_batch(cfg, b)["tokens"],
                                   rules.spec(("batch", None), (b, S)), mesh)
            steps, tally = collectives.count(_decode_spread, model, cache,
                                             tokens)
            res[f"seq-{family}"] = (steps, tally.each,
                                    str(cache["k"].placements))
    if rank == 0:
        torch.save(res, pathlib.Path(out) / "sharded.pt")
    dist.destroy_process_group()


# ------------------------------------------------------------- the test
def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def jax_setup():
    import jax
    from repro.configs.qwen3_8b import reduced as jax_reduced
    from repro.models.model_zoo import build_model as jax_build_model
    from repro.train import train_step as jts
    cfg = _cfg("dense")
    jmodel = jax_build_model(jax_reduced())
    jstate = jts.init_train_state(jmodel, jax.random.key(0))
    batch = {k: np.asarray(v) for k, v in _batch(cfg).items()}
    (total, _), grads = jax.jit(jax.value_and_grad(
        jts.make_loss_fn(jmodel), has_aux=True))(jstate.params, batch)
    to_np = lambda t: jax.tree.map(np.asarray, t)
    return to_np(jstate.params), float(total), to_np(grads)


@pytest.fixture(scope="module")
def ranks(jax_setup, tmp_path_factory):
    out = tmp_path_factory.mktemp("sharded")
    torch.save(jax_setup[0], out / "jax_params.pt")
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               GLOO_SOCKET_IFNAME="lo", OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, __file__, str(r), str(port), str(out)], cwd=ROOT,
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(4)]
    logs = [p.communicate(timeout=600)[0] for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    return torch.load(out / "sharded.pt", weights_only=False)


def _close(got, want, what):
    torch.testing.assert_close(got, want, rtol=TOL, atol=TOL, msg=what)


@pytest.mark.parametrize("case", list(CASES))
def test_sharded_train_step_equals_unsharded(ranks, case, monkeypatch):
    """Loss, every gradient and every param after one AdamW step."""
    _float32(monkeypatch.setattr)
    family, remat = CASES[case]
    cfg = _cfg(family, remat)
    loss, grads, after = _loss_grads_step(_model(cfg), _batch(cfg))
    got_loss, got_grads, got_after = ranks[case]
    assert abs(got_loss - loss) <= TOL * max(1.0, abs(loss))
    assert list(got_grads) == list(grads)
    assert sum(g.abs().sum() for g in grads.values()) > 0
    for path in grads:
        _close(got_grads[path], grads[path], f"{case} grad {path}")
        _close(got_after[path], after[path], f"{case} param {path}")


def test_sharded_prefill_and_decode_equal_unsharded(ranks, monkeypatch):
    """Under ``DECODE_RULES`` the cache's sequence is split over
    ``model``: the decode writes and attention reach it on every rank."""
    _float32(monkeypatch.setattr)
    cfg = _cfg("dense")
    model = _model(cfg)
    batch = _batch(cfg)
    logits, cache = _serve(model, cfg, batch)
    steps = _decode(model, cache, batch)
    got_logits, got_steps, placed = ranks["serve"]
    assert placed[0] == "(Shard(dim=1), Shard(dim=2))"   # batch, kv_seq
    _close(got_logits, logits, "prefill logits")
    _close(got_steps, steps, "decode logits")


@pytest.mark.parametrize("family", list(SEQ_CASES))
def test_seq_split_decode_equals_unsharded(ranks, family, monkeypatch):
    """Each rank decodes on its own cache shard and the partials merge;
    reduced qwen3-8b's sequence split over ``model``, reduced zamba2-7b's
    (batch 1, ``LONG_DECODE_RULES``) over ``data`` and ``model``."""
    _float32(monkeypatch.setattr)
    cfg = _cfg(family)
    model = _model(cfg)
    b = SEQ_CASES[family][1]
    want = _decode_spread(model, model.init_cache(b, S, torch.float32),
                          _batch(cfg, b)["tokens"])
    got, _, placed = ranks[f"seq-{family}"]
    assert placed == {"dense": "(Shard(dim=1), Shard(dim=2))",
                      "hybrid": "(Shard(dim=2), Shard(dim=2))"}[family]
    _close(got, want, f"{family} decode at {SPREAD}")


@pytest.mark.parametrize("family", list(SEQ_CASES))
def test_seq_split_decode_collectives(ranks, family):
    """No all-gather of a cache in a decode step: none of them has a
    cache shard's trailing dims (kh, S / pieces, hd), which the whole-cache
    path gathered twice an attention layer.  The merge's all-reduces, in
    each of the ``len(SPREAD)`` steps, an attention layer and a mesh dim
    that splits the sequence (group 2): the lse's max, (b_local, h)
    float32, and the sum of the weighted outputs beside their weights,
    (b_local, h, hd + 1).  qwen3-8b: batch 2 split over ``data``, 2 layers
    of 4 heads of 16, the sequence over ``model`` (32 a device): 2 x 5 =
    10 of each.  zamba2-7b: batch 1, 2 applications of the shared block
    (4 heads of 16), the sequence over both dims (16 a device): 2 x 2 x 5
    = 20 of each.  Other all-reduces (the weights' pending sums) have
    other shapes."""
    cfg = _cfg(family)
    hd = cfg.resolved_head_dim()
    _, each, _ = ranks[f"seq-{family}"]
    pieces, b_local, calls = {"dense": (2, 1, 2), "hybrid": (4, 1, 4)}[family]
    tail = (cfg.num_kv_heads, S // pieces, hd)
    gathers = [shape for kind, shape, _ in each if kind == "all-gather"]
    assert gathers and not [g for g in gathers if g[-3:] == tail]
    lse, acc = (b_local, cfg.num_heads), (b_local, cfg.num_heads, hd + 1)
    merged = [(shape, n) for kind, shape, n in each
              if kind == "all-reduce" and shape in (lse, acc)]
    want = calls * len(SPREAD)
    assert sorted(merged) == sorted([(lse, 2)] * want + [(acc, 2)] * want)


def test_sharded_bf16_step_matches_jax(ranks, jax_setup):
    """Reduced qwen3-8b, bf16 compute, on JAX's weights."""
    from repro_torch.models.params import tree_leaves
    _, jtotal, jgrads = jax_setup
    loss, grads = ranks["bf16"]
    assert abs(loss - jtotal) < LOSS_TOL
    for path, g in tree_leaves(jgrads):
        got = grads[path].double().numpy()
        g = np.asarray(g, np.float64)
        assert np.abs(g).max() > 0, path
        rel = np.linalg.norm(got - g) / np.linalg.norm(g)
        assert rel < GRAD_REL_L2, (path, rel)


if __name__ == "__main__":
    _rank_main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
