"""The port's copies of the chaos injector and the co-located baseline,
against ``repro``'s, on the CPU.

``repro_torch.chaos`` (the fault schedules, the injector, the policies'
re-exports) and ``repro_torch.core.colocated`` are the reference's text
with the imports renamed (``tests/test_torch_data_plane_copy.py``).  Here
they run: a seeded schedule is the same file from both packages, a short
chaos soak on the port's Overlord loses and duplicates no sample under a
strict ``DeliveryLedger`` (``tests/test_chaos.py``'s soak, shortened), and
the port's ``ColocatedFleet`` holds more resident bytes than the port's
Overlord on ``tests/test_system.py::test_memory_smaller_than_colocated``'s
inputs, as the reference's test asserts of its own.
"""
import time

import pytest

from repro.chaos import FaultSchedule as RefSchedule

from repro_torch.chaos import FaultInjector, FaultSchedule
from repro_torch.configs import get_config
from repro_torch.core import (
    ClientPlaceTree, Overlord, OverlordConfig, StaticSchedule,
)
from repro_torch.core.colocated import ColocatedFleet
from repro_torch.data.cost_models import backbone_cost
from repro_torch.data.sources import (
    coyo_like_specs, materialize_group, navit_like_specs,
)

SEED = 1234
STEPS = 40
N_SOURCES = 3


@pytest.mark.parametrize("seed", [0, 7, SEED])
@pytest.mark.parametrize("kind", ["generate", "process_death_soak"])
def test_schedule_json_is_the_same_in_both_packages(tmp_path, seed, kind):
    ours = getattr(FaultSchedule, kind)(seed, 60)
    ref = getattr(RefSchedule, kind)(seed, 60)
    ours.save(str(tmp_path / "port.json"))
    ref.save(str(tmp_path / "ref.json"))
    assert (tmp_path / "port.json").read_text() \
        == (tmp_path / "ref.json").read_text()
    assert FaultSchedule.load(str(tmp_path / "ref.json")) == ours


def test_port_chaos_soak_loses_and_duplicates_nothing(tmp_path):
    """A seeded schedule against the port's live Overlord for ``STEPS``
    steps: delivery never raises, the strict ledger proves no loss, no
    duplicate, no rank skew and no quarantine leak, the required fault
    kinds fire, and corrupted samples reach the dead-letter queue with
    their source."""
    paths = materialize_group(coyo_like_specs(N_SOURCES), str(tmp_path))
    tree = ClientPlaceTree([("PP", 1), ("DP", 2), ("CP", 1), ("TP", 1)])
    cfg = get_config("qwen3-8b")
    ov = Overlord(paths, tree, StaticSchedule({n: 1.0 for n in paths}),
                  OverlordConfig(
                      seq_len=256, rows_per_microbatch=2, n_bins=1,
                      strategy="backbone_balance", shadows=True, ledger=True,
                      loader_ckpt_every=4,
                      strategy_params=dict(costfn=backbone_cost(cfg),
                                           broadcast=()))).start()
    schedule = FaultSchedule.generate(SEED, STEPS)
    injector = FaultInjector(ov, schedule)
    try:
        for step in range(STEPS):
            injector.on_step(step)
            for r in range(ov.tree.world):
                v = ov.get_batch(step, r, timeout=30)
                assert v["role"] in ("data", "metadata", "none")
            ov.step_done(step)
        time.sleep(0.3)            # let in-flight recoveries settle
        ov.step_done(STEPS - 1)    # refresh the quarantine mirror
        summary = ov.ledger.verify(strict=True)
        timeline = injector.timeline()
        dlq = ov.dlq.counts_by_source()
    finally:
        injector.uninstall()
        ov.shutdown()
    assert summary["ok"] and summary["delivered"] > 0
    assert summary["lost"] == [] and summary["duplicates"] == {}
    assert summary["rank_skew"] == [] and summary["quarantine_leaks"] == []
    assert {"crash_loader", "corrupt", "io_error"} <= {
        k for (_, k, _, _) in timeline}
    assert sum(dlq.values()) > 0 and set(dlq) <= set(paths)


def test_colocated_fleet_holds_more_than_the_overlord(tmp_path):
    """Per-source loaders against per-rank, all-source co-located loaders,
    resident bytes, on the reference test's inputs: 12 navit-like sources
    of 256 samples, DP 16, 8 workers a rank, 512 tokens, 2 rows."""
    from repro_torch.core.autoscale import PartitionLimits
    paths = materialize_group(
        [s.__class__(**{**s.__dict__, "n_samples": 256})
         for s in navit_like_specs(12)], str(tmp_path))
    dp, workers = 16, 8
    tree = ClientPlaceTree([("PP", 1), ("DP", dp), ("CP", 1), ("TP", 1)])
    cfg = get_config("qwen3-8b")
    sched = StaticSchedule({n: 1.0 for n in paths})
    ov = Overlord(paths, tree, sched, OverlordConfig(
        seq_len=512, rows_per_microbatch=2, n_bins=1,
        strategy="backbone_balance",
        strategy_params=dict(costfn=backbone_cost(cfg), broadcast=()),
        shadows=False, buffer_target=64,
        limits=PartitionLimits(total_workers=16, w_actor=2),
    )).start()
    try:
        for step in range(2):
            for r in range(ov.tree.world):
                ov.get_batch(step, r)
            ov.step_done(step)
        ov_mem = ov.memory_report()["total_ex_shadows"]
    finally:
        ov.shutdown()
    fleet = ColocatedFleet(paths, dp, workers, 512, 2, sched)
    try:
        co_mem = fleet.memory_bytes()
    finally:
        fleet.close()
    assert 0 < ov_mem < co_mem, (ov_mem, co_mem)
