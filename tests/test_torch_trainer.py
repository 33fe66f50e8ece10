"""The port's Overlord-fed training loop vs the JAX package, on the CPU.

The data plane: ``repro``'s Overlord and the port's copy, with the
configuration ``chip_smoke.py``'s trainer phase runs at a CPU size
(``seq_len`` 256), hand out bitwise-equal batches when live (actor threads
and all), and keep the same delivery ledger, sample by sample, when run
synchronously.  The slice as a whole: the port's ``Trainer`` takes three
steps on reduced qwen3-8b, and on reduced rwkv6-3b, from the JAX trainer's
initial state, and the JAX train step runs on the very numpy batches the
port's trainer assembled; losses, gradient norms and what the steps added
to each leaf are held to ``tests/test_torch_train.py``'s tolerances.
Checkpoints load across in both directions, and the launcher runs.
"""
import tempfile
import threading

import jax
import numpy as np
import pytest
import torch

from repro.configs.qwen3_8b import reduced as jax_reduced
from repro.models.model_zoo import build_model as jax_build_model
from repro.train import optimizer as jopt
from repro.train import train_step as jts
from repro.train import trainer as jtrainer

from repro_torch.configs.qwen3_8b import reduced
from repro_torch.models.convert import params_from_jax
from repro_torch.models.model_zoo import build_model
from repro_torch.models.params import tree_leaves
from repro_torch.train import train_step as port_train_step
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.trainer import Trainer, TrainerConfig, state_leaves

from test_pipeline import _SyncHandle
from test_torch_train import GRAD_REL_L2, LOSS_TOL, OPT, UPDATE_REL_L2

KEYS = ("tokens", "segment_ids", "positions", "labels")
STEPS = 3


def _overlord(pkg: str, root: str, cost_cfg, vocab: int, seq_len: int = 256,
              validate: bool = True, strategy: str = "backbone_balance"):
    """The trainer phase's data plane from package ``pkg``: four coyo-like
    sources, equal weights, DP 4, one row and one bin per bucket, 96
    samples a step, a strict ledger, the launch-time analysis (the
    Overlord's default).  Under
    ``hybrid_balance`` the strategy takes the launchers' costs: the
    backbone's, and ViT-2B's for the images."""
    import importlib
    core = importlib.import_module(f"{pkg}.core")
    costs = importlib.import_module(f"{pkg}.data.cost_models")
    sources = importlib.import_module(f"{pkg}.data.sources")
    specs = sources.coyo_like_specs(4)
    paths = sources.materialize_group(specs, root)
    tree = core.ClientPlaceTree([("PP", 1), ("DP", 4), ("CP", 1),
                                 ("TP", 1)])
    if strategy == "hybrid_balance":
        sparams = dict(backbone_costfn=costs.backbone_cost(cost_cfg),
                       encoder_costfn=costs.encoder_cost(48, 1664))
    else:
        sparams = dict(costfn=costs.backbone_cost(cost_cfg))
    return core.Overlord(
        paths, tree, core.StaticSchedule({s.name: 1.0 for s in specs}),
        core.OverlordConfig(
            seq_len=seq_len, rows_per_microbatch=1, n_bins=1,
            samples_per_step=96, strategy=strategy,
            strategy_params=dict(sparams, broadcast=()),
            vocab_size=vocab, ledger=True), validate=validate)


class _SyncClient:
    """``TrainerClient`` stand-in: fetches on the caller's thread, the
    step asked for and the ``prefetch`` - 1 after it, as the live client's
    ring does."""

    def __init__(self, rank: int, fetch, prefetch: int):
        self.rank, self._fetch, self.prefetch = rank, fetch, prefetch
        self._buf: dict[int, dict] = {}

    def get(self, step: int, timeout=None) -> dict:
        for s in range(step, step + self.prefetch):
            if s not in self._buf:
                self._buf[s] = self._fetch(s, self.rank)
        return self._buf.pop(step)

    def close(self):
        pass


def _synchronous(ov):
    """Run ``ov``'s actors through ``tests/test_pipeline.py``'s
    ``_SyncHandle`` and its clients through ``_SyncClient``: every call,
    the planner's run-ahead included, happens on the caller's thread, so
    the whole delivery ledger follows the seeds alone."""
    started = []

    def spawn(name, actor):
        actor.name = name
        actor.on_start()
        started.append(actor)
        return _SyncHandle(actor)
    ov.runtime.spawn = spawn
    ov._spawn_clients = lambda start_step: ov.clients.update(
        {r: _SyncClient(r, ov._fetch_view, ov.cfg.prefetch)
         for r in range(ov.tree.world)})
    return ov, started


def _batches(pkg: str, cost_cfg, steps: int = 4, synchronous=False,
             strategy: str = "backbone_balance"):
    """``steps`` global batches from ``pkg``'s Overlord, its strict
    ``verify()`` report and its ledger's snapshot."""
    with tempfile.TemporaryDirectory() as root:
        ov, started = _overlord(pkg, root, cost_cfg, 151_936,
                                strategy=strategy), []
        if synchronous:
            ov, started = _synchronous(ov)
        try:
            ov.start()
            out = []
            for step in range(steps):
                parts = []
                for rank in ov.tree.data_fetching_clients("DP"):
                    view = ov.get_batch(step, rank)
                    if view["role"] == "data":
                        parts += view["bins"]
                out.append({k: np.concatenate([getattr(p, k)
                                               for p in parts]) for k in KEYS})
                ov.step_done(step)
            return out, ov.ledger.verify(strict=True), ov.ledger.snapshot()
        finally:
            ov.shutdown()
            for actor in started:
                actor.on_stop()


def _assert_same_batches(got, ref):
    for step, (g, e) in enumerate(zip(got, ref)):
        assert g["tokens"].shape == (4, 256)
        assert (g["segment_ids"] > 0).any(), step
        for k in KEYS:
            np.testing.assert_array_equal(g[k], e[k], err_msg=f"{step} {k}")


def _qwen3_8b_cut(pkg: str):
    import importlib
    return importlib.import_module(f"{pkg}.configs").get_config(
        "qwen3-8b").replace(num_layers=8)


def test_data_plane_copy_hands_out_the_reference_batches():
    """Live planes (actor threads, prefetching clients): the batches are
    bitwise the reference's, and each ledger verifies strictly."""
    ref, ref_report, _ = _batches("repro", _qwen3_8b_cut("repro"))
    got, report, _ = _batches("repro_torch", _qwen3_8b_cut("repro_torch"))
    assert ref_report["ok"] and report["ok"]
    assert report["through_step"] == ref_report["through_step"] == 3
    _assert_same_batches(got, ref)


def test_data_plane_copy_keeps_the_reference_ledger():
    """Synchronous planes: the whole strict ``verify()`` report and every
    sample's record (planned, delivered, by rank, dropped with its reason)
    equal the reference's, and the batches equal the live plane's."""
    ref, ref_report, ref_snap = _batches("repro", _qwen3_8b_cut("repro"),
                                         synchronous=True)
    got, report, snap = _batches("repro_torch", _qwen3_8b_cut("repro_torch"),
                                 synchronous=True)
    assert report == ref_report and report["ok"]
    assert report["through_step"] == 3 and report["dropped"] > 0
    assert snap == ref_snap
    _assert_same_batches(got, ref)
    live, _, _ = _batches("repro_torch", _qwen3_8b_cut("repro_torch"))
    _assert_same_batches(got, live)


def test_data_plane_copy_keeps_the_reference_ledger_under_hybrid_balance():
    """Synchronous planes under ``hybrid_balance``: the batches, the whole
    strict ``verify()`` report and every sample's record equal the
    reference's.  (Both packages' strategy reads the backbone cost where
    it means the encoder's, so its plan is ``backbone_balance``'s; ROADMAP
    C4.  The copy is held to the reference as it is.)"""
    ref, ref_report, ref_snap = _batches(
        "repro", _qwen3_8b_cut("repro"), synchronous=True,
        strategy="hybrid_balance")
    got, report, snap = _batches(
        "repro_torch", _qwen3_8b_cut("repro_torch"), synchronous=True,
        strategy="hybrid_balance")
    assert report == ref_report and report["ok"]
    assert report["through_step"] == 3
    assert snap == ref_snap
    _assert_same_batches(got, ref)


def _rel(got, exp) -> float:
    got, exp = np.asarray(got, np.float64), np.asarray(exp, np.float64)
    return float(np.linalg.norm(got - exp) / np.linalg.norm(exp))


@pytest.mark.parametrize("arch", ["qwen3-8b", "rwkv6-3b"])
def test_overlord_fed_steps_match_jax(arch, monkeypatch):
    """Three steps of the port's ``Trainer`` on its own Overlord, and the
    jitted JAX train step on the batches that trainer assembled.  The
    rwkv6-3b case computes in float32 on both sides: with the bf16 compute
    copy its gradients are rounding in both frameworks
    (tests/test_torch_rwkv_train.py)."""
    import importlib
    module = arch.replace("-", "_")
    cfg = importlib.import_module(f"repro_torch.configs.{module}").reduced()
    opt = AdamWConfig(**OPT)
    jmodel = jax_build_model(importlib.import_module(
        f"repro.configs.{module}").reduced())
    if cfg.family == "ssm":
        monkeypatch.setattr(jts, "_cast_for_compute",
                            lambda params, compute_dtype=None: params)
        monkeypatch.setattr(port_train_step, "COMPUTE_DTYPE", torch.float32)
    jstate = jtrainer.Trainer(jmodel, None, jtrainer.TrainerConfig(
        opt=jopt.AdamWConfig(**OPT))).state
    np_state = jax.tree.map(np.asarray, jstate)
    model = params_from_jax(np_state.params, cfg, "cpu")
    with tempfile.TemporaryDirectory() as root:
        ov = _overlord("repro_torch", root, cfg, cfg.vocab_size)
        try:
            ov.start()
            trainer = Trainer(model, ov, TrainerConfig(opt=opt))
            assembled = []
            assemble = trainer._assemble_global_batch

            def keep(step):
                batch = assemble(step)
                assembled.append({k: v.numpy().copy()
                                  for k, v in batch.items()})
                return batch
            trainer._assemble_global_batch = keep
            hist = trainer.train(STEPS)
        finally:
            ov.shutdown()
    assert trainer.device.type == "cpu"
    assert [r["step"] for r in hist] == list(range(STEPS))
    jstep = jax.jit(jts.make_train_step(jmodel, jopt.AdamWConfig(**OPT)))
    for rec, batch in zip(hist, assembled):
        assert batch["tokens"].shape == (4, 256)
        assert (batch["segment_ids"] > 0).any()
        jstate, jm = jstep(jstate, batch)
        assert abs(rec["loss"] - float(jm["loss"])) < LOSS_TOL, rec
        assert abs(rec["grad_norm"] - float(jm["grad_norm"])) \
            < GRAD_REL_L2 * float(jm["grad_norm"]), rec
    assert int(trainer.state.opt.step) == int(jstate.opt.step) == STEPS
    before = dict(tree_leaves(np_state.params))
    for (path, p), (_, e) in zip(tree_leaves(trainer.state.params),
                                 tree_leaves(jax.tree.map(np.asarray,
                                                          jstate.params))):
        exp = np.asarray(e, np.float64) - before[path]
        assert np.abs(exp).max() > 0, path
        rel = _rel(p.detach().double().numpy() - before[path], exp)
        assert rel < UPDATE_REL_L2, (path, rel)


def _random_jax_state(seed: int):
    """A JAX trainer state with nonzero moments and step count."""
    rng = np.random.default_rng(seed)
    state = jtrainer.Trainer(jax_build_model(jax_reduced()), None,
                             seed=seed).state
    moment = lambda x: rng.normal(size=x.shape).astype(np.float32)  # noqa
    return state._replace(opt=jopt.AdamWState(
        np.int32(7), jax.tree.map(moment, state.opt.mu),
        jax.tree.map(moment, state.opt.nu)))


def test_checkpoints_load_across_both_ways(tmp_path):
    cfg = reduced()
    port = Trainer(build_model(cfg, torch.Generator().manual_seed(1)), None,
                   TrainerConfig(ckpt_dir=str(tmp_path / "port")))
    jax_side = jtrainer.Trainer(jax_build_model(jax_reduced()), None,
                                jtrainer.TrainerConfig(
                                    ckpt_dir=str(tmp_path / "jax")))
    jax_side.state = _random_jax_state(3)
    jax_side.save_checkpoint(5)
    port.cfg.ckpt_dir = jax_side.cfg.ckpt_dir
    port.load_checkpoint(5)
    flat = jax.tree.leaves(jax_side.state)
    got = state_leaves(port.state)
    assert len(got) == len(flat)
    for i, (g, e) in enumerate(zip(got, flat)):
        np.testing.assert_array_equal(g.detach().numpy(), np.asarray(e),
                                      err_msg=str(i))
    assert int(port.state.opt.step) == 7

    # the port's own state, changed, back into a fresh JAX trainer
    with torch.no_grad():
        for t in state_leaves(port.state):
            t.add_(1)
    port.cfg.ckpt_dir = str(tmp_path / "port")
    port.save_checkpoint(6)
    fresh = jtrainer.Trainer(jax_build_model(jax_reduced()), None,
                             jtrainer.TrainerConfig(ckpt_dir=str(
                                 tmp_path / "port")))
    fresh.load_checkpoint(6)
    flat = jax.tree.leaves(fresh.state)
    for i, (g, e) in enumerate(zip(state_leaves(port.state), flat)):
        assert np.asarray(e).dtype == g.detach().numpy().dtype, i
        np.testing.assert_array_equal(np.asarray(e), g.detach().numpy(),
                                      err_msg=str(i))
    assert int(fresh.state.opt.step) == 8


def test_checkpoint_of_another_shape_is_refused(tmp_path):
    big = Trainer(build_model(reduced().replace(num_layers=3),
                              torch.Generator().manual_seed(0)), None,
                  TrainerConfig(ckpt_dir=str(tmp_path)))
    big.save_checkpoint(1)
    small = Trainer(build_model(reduced(), torch.Generator().manual_seed(0)),
                    None, TrainerConfig(ckpt_dir=str(tmp_path)))
    with pytest.raises(ValueError, match="shape"):
        small.load_checkpoint(1)


def test_launcher_trains_on_the_cpu():
    from repro_torch.launch import train
    out = train.main(["--reduced", "--device", "cpu", "--steps", "3",
                      "--seq-len", "128"])
    hist = out["history"]
    assert len(hist) == 3 and np.isfinite([r["loss"] for r in hist]).all()
    assert out["trainer"].device.type == "cpu"


def test_launcher_trains_under_hybrid_balance_on_the_cpu():
    from repro_torch.launch import train
    out = train.main(["--reduced", "--device", "cpu", "--steps", "3",
                      "--seq-len", "128", "--strategy", "hybrid_balance"])
    hist = out["history"]
    assert len(hist) == 3 and np.isfinite([r["loss"] for r in hist]).all()
    assert out["trainer"].ov.cfg.strategy == "hybrid_balance"


@pytest.mark.parametrize("argv,error", [
    (["--arch", "whisper-medium", "--reduced"], ValueError),
], ids=["audio-family"])
def test_launcher_refuses_what_is_not_ported(argv, error):
    """whisper-medium (the audio family) does not train from the Overlord:
    its batches carry no ``enc_embeds``, and the JAX package trains the
    family on a fixed batch only; asking for it names ROADMAP.md."""
    from repro_torch.launch import train
    with pytest.raises(error, match="ROADMAP.md"):
        train.main(argv + ["--device", "cpu", "--steps", "1"])


def test_gap_closed_is_the_share_of_the_gap_to_ln_v_minus_1():
    from repro_torch.train.trainer import gap_closed
    floor = float(np.log(255))
    losses = [floor + 2.0] * 5 + [floor + 0.5] * 5
    assert gap_closed(losses, 256) == pytest.approx(
        (floor + 2.0, floor + 0.5, 0.75))
    assert gap_closed(losses[:5] * 2, 256)[2] == 0.0
    assert gap_closed(losses, 256, n=10)[2] == 0.0


def test_overlord_validate_runs_the_analysis_and_refuses_before_threads():
    """``Overlord(validate=True)``, the default, runs the port's static
    analysis at launch: the trainer phase's plane passes it and keeps the
    report, and a configuration it refuses (``vanilla`` given the
    ``broadcast`` it does not accept, as both training launchers pass it:
    CFG304) raises ``repro_torch.analysis.AnalysisError`` before any
    thread starts, with the rule ids ``repro``'s Overlord reports."""
    from repro_torch.analysis import AnalysisError
    from repro_torch.configs import get_config
    cfg = get_config("qwen3-8b")
    with tempfile.TemporaryDirectory() as root:
        ov = _overlord("repro_torch", root, cfg, 256)
        try:
            assert ov.analysis.ok
            assert not ov.analysis.errors
        finally:
            ov.shutdown()
    before = set(threading.enumerate())
    rules = {}
    for pkg, error in (("repro", None), ("repro_torch", AnalysisError)):
        with tempfile.TemporaryDirectory() as root:
            with pytest.raises(Exception) as info:
                _overlord(pkg, root, cfg, 256, strategy="vanilla")
        assert type(info.value).__name__ == "AnalysisError"
        assert error is None or isinstance(info.value, error)
        rules[pkg] = sorted(f.rule for f in info.value.report.errors)
    assert rules["repro_torch"] == rules["repro"] and rules["repro"]
    assert not set(threading.enumerate()) - before
