"""The port's copy of the static analysis, against ``repro``'s, on the CPU.

``repro_torch.analysis`` is ``repro.analysis`` with its imports renamed
(``tests/test_torch_data_plane_copy.py``); its ``config_lint`` reads the
port's ``ModelConfig`` (``dtype`` and ``remat`` among its fields) and the
port's registry.  Here both packages judge the same inputs: a seeded bad
fixture through each package's CLI, bad ``OverlordConfig``s and
``ModelConfig``s through each package's linters, with the same rule ids
and severities.  The port's CLI is clean on the shipped surface, all of
``src/`` (the port included), and every port config lints clean.
"""
import importlib
import json
import os
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PACKAGES = ("repro", "repro_torch")

BAD_FIXTURE = """
import threading
from {pkg}.configs.base import ModelConfig
from {pkg}.core.actors import Actor
from {pkg}.core.orchestrator import OverlordConfig

BAD_MODEL = ModelConfig(
    name="bad-fixture", family="dense", num_layers=2, d_model=100,
    num_heads=3, num_kv_heads=2, d_ff=64, vocab_size=0, remat="all")

BAD_OVERLORD = OverlordConfig(strategy="does_not_exist", fill_factor=3.5)


class BadActor(Actor):
    def checkpoint_state(self):
        return {{}}

    def wait(self, peer):
        return peer.call("x", timeout=None)
"""

# OverlordConfig fields that the analysis refuses or warns of, each as the
# reference's own tests seed them (tests/test_analysis.py)
BAD_OVERLORD = {
    "dims_and_fill": dict(fill_factor=1.5, seq_len=0),
    "unknown_strategy": dict(strategy="nope"),
    "strategy_param": dict(extra_param=1),
    "broadcast_for_vanilla": dict(strategy="vanilla"),
    "unknown_axis": dict(axis="EP"),
    "bins_unfilled": dict(samples_per_step=2, n_bins=2),
    "ckpt_order": dict(planner_ckpt_every=8, loader_ckpt_every=1),
    "plan_ahead": dict(plan_ahead=-1),
    "manifest": dict(manifest_every=0),
}


def _cli(pkg: str, *args: str) -> subprocess.CompletedProcess:
    return subprocess.run(
        [sys.executable, "-m", f"{pkg}.analysis.lint", *args], cwd=ROOT,
        capture_output=True, text=True, timeout=120,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                 JAX_PLATFORMS="cpu"))


def _found(report) -> list:
    return sorted((f.rule, f.severity.name) for f in report.findings)


def _overlord_cfg(pkg: str, bad: dict):
    core = importlib.import_module(f"{pkg}.core")
    costs = importlib.import_module(f"{pkg}.data.cost_models")
    cfgs = importlib.import_module(f"{pkg}.configs")
    bad = dict(bad)
    sparams = dict(costfn=costs.backbone_cost(cfgs.get_config("qwen3-8b")),
                   broadcast=())
    for key in ("extra_param", "axis"):
        if key in bad:
            sparams[key] = bad.pop(key)
    kw = dict(seq_len=256, rows_per_microbatch=1, n_bins=1,
              strategy="backbone_balance", strategy_params=sparams)
    kw.update(bad)
    return core.OverlordConfig(**kw), core.ClientPlaceTree(
        [("PP", 1), ("DP", 4), ("CP", 1), ("TP", 1)])


def test_seeded_bad_fixture_gives_the_same_findings_in_both_clis(tmp_path):
    found = {}
    for pkg in PACKAGES:
        path = tmp_path / f"bad_fixture_{pkg}.py"
        path.write_text(BAD_FIXTURE.format(pkg=pkg))
        proc = _cli(pkg, str(path), "--format", "json")
        assert proc.returncode == 1, proc.stdout + proc.stderr
        found[pkg] = sorted((f["rule"], f["severity"])
                            for f in json.loads(proc.stdout)["findings"])
    assert found["repro_torch"] == found["repro"]
    assert {"MDL401", "MDL405", "CFG302", "CFG303", "ACT504", "ACT505"} \
        <= {rule for rule, _ in found["repro"]}


@pytest.mark.parametrize("case", sorted(BAD_OVERLORD))
def test_bad_overlord_config_gives_the_same_findings(case):
    found = {}
    for pkg in PACKAGES:
        analysis = importlib.import_module(f"{pkg}.analysis")
        cfg, tree = _overlord_cfg(pkg, BAD_OVERLORD[case])
        found[pkg] = _found(analysis.validate_launch(cfg, tree, n_sources=4))
    assert found["repro_torch"] == found["repro"]
    assert found["repro"], case


def test_good_overlord_config_is_clean_in_both():
    for pkg in PACKAGES:
        analysis = importlib.import_module(f"{pkg}.analysis")
        cfg, tree = _overlord_cfg(pkg, {})
        rep = analysis.validate_launch(cfg, tree, n_sources=4)
        assert rep.ok and len(rep) == 0, rep.as_text()


@pytest.mark.parametrize("bad", [
    dict(family="quantum", dtype="float8", remat="everything"),
    dict(remat="selective"),
    dict(head_dim=0, d_model=100, num_heads=3, num_kv_heads=2,
         num_experts=4, experts_per_token=8),
], ids=["enums", "remat", "geometry"])
def test_bad_model_config_gives_the_same_findings(bad):
    found = {}
    for pkg in PACKAGES:
        analysis = importlib.import_module(f"{pkg}.analysis")
        cfgs = importlib.import_module(f"{pkg}.configs")
        cfg = cfgs.get_config("qwen3-8b").replace(name="bad", **bad)
        found[pkg] = _found(analysis.lint_model_config(cfg))
    assert found["repro_torch"] == found["repro"] and found["repro"]


def test_cli_is_clean_on_the_shipped_surface():
    """``python -m repro_torch.analysis.lint`` with no path lints the
    shipped strategies, every port config and a launch config, and walks
    every ``.py`` under ``src/``, as the reference's CLI does."""
    proc = _cli("repro_torch")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "analysis: clean (0 findings)" in proc.stdout
    proc = _cli("repro_torch", "src/repro_torch/configs")
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_every_port_config_lints_clean():
    from repro_torch.analysis import lint_model_config, \
        lint_shipped_model_configs
    from repro_torch.configs import get_config, list_configs
    from repro_torch.configs.base import _PORTED
    rep = lint_shipped_model_configs()
    assert rep.ok and len(rep) == 0, rep.as_text()
    assert len(list_configs()) == 13
    for name in list_configs():
        cfg = get_config(name)
        assert (cfg.dtype, cfg.remat) == ("bfloat16", "layer"), name
    reduced = [importlib.import_module(f"repro_torch.configs.{m}")
               for m in _PORTED]
    reduced = [m.reduced() for m in reduced if hasattr(m, "reduced")]
    assert len(reduced) == 11
    for cfg in reduced:
        rep = lint_model_config(cfg)
        assert rep.ok and len(rep) == 0, (cfg.name, rep.as_text())


def test_launcher_refuses_vanilla_as_the_reference_does():
    """Both training launchers put ``broadcast`` in every strategy's
    params, which ``vanilla`` does not accept: the Overlord's launch-time
    analysis refuses it (CFG304) in the port as in the reference."""
    from repro_torch.analysis import AnalysisError
    from repro_torch.launch import train
    with pytest.raises(AnalysisError, match="CFG304"):
        train.main(["--reduced", "--device", "cpu", "--strategy", "vanilla",
                    "--steps", "1"])
