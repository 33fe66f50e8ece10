"""Planner actor: centralized, declarative data plane (§3, §4).

Per step: collect buffer metadata from Source Loaders -> run the user
strategy over a fresh Orchestration -> emit the LoadingPlan -> direct
loaders to prepare+deposit samples into the Data Constructors.  Also the
control-plane brain: mixture schedule, plan history (replay window for
differential checkpointing), and mixture-driven scaling triggers (§5.2).
"""
from __future__ import annotations

import collections
import pickle
import time
from typing import Callable, Optional

import numpy as np

from repro_torch.core.actors import Actor, ActorHandle, FanOut
from repro_torch.core.mixing import MixSchedule
from repro_torch.core.placetree import ClientPlaceTree
from repro_torch.core.primitives import LoadingPlan, Orchestration
from repro_torch.core.resilience import RetryPolicy
from repro_torch.telemetry import Telemetry, ensure_telemetry


class _HealthyRemix(MixSchedule):
    """Schedule view that zeroes degraded sources, re-mixing their weight
    across healthy ones (circuit-breaker fallback, §6 hardening)."""

    def __init__(self, base: MixSchedule, degraded: set):
        self.base = base
        self.degraded = set(degraded)

    def weights(self, step: int) -> dict[str, float]:
        w = self.base.weights(step)
        healthy = {k: v for k, v in w.items() if k not in self.degraded}
        return healthy if healthy else w

    def observe(self, step: int, metrics: dict) -> None:
        self.base.observe(step, metrics)


class Planner(Actor):
    def __init__(self, tree: ClientPlaceTree, schedule: MixSchedule,
                 strategy: Callable, strategy_params: dict,
                 loaders: dict[str, ActorHandle],
                 constructors: dict[int, ActorHandle],
                 samples_per_step: int, seed: int = 0,
                 scale_threshold: float = 1.5,
                 scale_patience: int = 3,
                 ledger=None,
                 call_retry: Optional[RetryPolicy] = None,
                 telemetry: Optional[Telemetry] = None,
                 plan_ahead: int = 0,
                 fanout: bool = True):
        self.tree = tree
        self.schedule = schedule
        self.strategy = strategy
        self.strategy_params = dict(strategy_params)
        self.loaders = dict(loaders)          # name -> handle
        self.constructors = dict(constructors)
        self.samples_per_step = samples_per_step
        self.seed = seed
        self._planned_through = -1
        self._history: collections.OrderedDict = collections.OrderedDict()
        self._diag_log: list[dict] = []
        # mixture-driven scaling state (§5.2)
        self._weight_ema: dict[str, float] = {}
        self._over_count: collections.Counter = collections.Counter()
        self._under_count: collections.Counter = collections.Counter()
        self.scale_threshold = scale_threshold
        self.scale_patience = scale_patience
        self._scale_events: list[dict] = []
        self._scale_cb: Optional[Callable] = None
        self.ledger = ledger
        self.telemetry = ensure_telemetry(telemetry)
        self.call_retry = call_retry or RetryPolicy(
            max_attempts=2, base_delay_s=0.01, max_delay_s=0.1, seed=seed)
        self._degraded_log: list[dict] = []
        # pipelined planning (docs/PERFORMANCE.md): the Overlord casts
        # advance_to(step + plan_ahead) after every fetch, so steps ahead
        # of the consumer are planned on this mailbox thread while the
        # trainer consumes; fanout=False restores the serial-RPC baseline
        self.plan_ahead = max(int(plan_ahead), 0)
        self.fanout = fanout
        self._last_requested = -1

    # -- wiring ------------------------------------------------------------
    def set_loaders(self, loaders: dict[str, ActorHandle]):
        self.loaders = dict(loaders)

    def set_scale_callback(self, cb: Callable):
        """cb(source, direction) -> None; installed by the AutoScaler."""
        self._scale_cb = cb

    # -- planning ------------------------------------------------------------
    def ensure_planned(self, step: int) -> int:
        self._last_requested = max(self._last_requested, step)
        while self._planned_through < step:
            self._plan_one(self._planned_through + 1)
        return self._planned_through

    def advance_to(self, target: int) -> int:
        """Plan-ahead prefetch: plan steps up to ``target`` in the
        background (the Overlord casts this — no caller blocks on it).
        Steps planned here are already deposited in the constructors by
        the time a client asks, so ``get_batch`` only touches the
        planner on a cold start or after a replan."""
        if self._planned_through >= target:
            return self._planned_through
        with self.telemetry.span("planner.pipeline", target=target,
                                 behind=target - self._planned_through):
            while self._planned_through < target:
                self._plan_one(self._planned_through + 1)
        return self._planned_through

    def replan(self, step: int) -> bool:
        """Re-execute a step's plan after recovery: a planner that died
        mid-plan may have 'planned' a step no constructor holds.  Allowed
        once per step per incarnation (the data differs from the lost plan
        — it is fresh buffered data, which is fine: samples are exchangeable
        within the mixture)."""
        if not hasattr(self, "_replanned"):
            self._replanned: set[int] = set()
        if step in self._replanned or step > self._planned_through:
            return False
        self._replanned.add(step)
        self._plan_one(step)
        return True

    def _collect_buffers(self) -> tuple[list[dict], dict[str, str], set]:
        """Merge loader buffers; map sample_id -> owning loader name; and
        collect the set of DEGRADED sources (open circuit breaker) the
        mixture should route around.  One ``snapshot`` RPC per loader
        (metadata + health merged), issued as a single overlapped wave:
        the collect stage pays one max-latency, not a sum of round-trips.
        """
        alive = {n: h for n, h in self.loaders.items() if h.alive}
        if self.fanout:
            fo = FanOut(telemetry=self.telemetry)
            for name, h in alive.items():
                fo.submit(name, h, "snapshot", timeout=10)
            snaps = fo.gather()
        else:
            snaps = {}
            for name, h in alive.items():   # perf: serial ok — baseline
                try:
                    snaps[name] = h.call("snapshot", timeout=10)
                except Exception:
                    continue
        meta, owner, degraded = [], {}, set()
        for name in alive:                 # loader order, not completion
            snap = snaps.get(name)
            if snap is None:
                continue
            health = snap["health"]
            if health.get("breaker") == "open":
                degraded.add(health["source"])
            for m in snap["entries"]:
                meta.append(m)
                owner[m["sample_id"]] = name
        return meta, owner, degraded

    def _plan_one(self, step: int):
        tel = self.telemetry
        t0 = time.perf_counter()
        with tel.span("planner.plan_step", step=step):
            with tel.span("planner.collect", step=step) as sp:
                buffer_meta, owner, degraded = self._collect_buffers()
                sp.set_attr("buffered", len(buffer_meta))
            schedule = self.schedule
            if degraded:
                # fallback re-mix: weight of broken sources flows to
                # healthy ones instead of starving the step
                # (docs/FAULT_TOLERANCE.md)
                schedule = _HealthyRemix(self.schedule, degraded)
                self._degraded_log.append(
                    {"step": step, "degraded": sorted(degraded)})
                tel.inc("planner_degraded_steps_total")
            with tel.span("planner.strategy", step=step,
                          strategy=getattr(self.strategy, "__name__",
                                           "strategy")):
                # selection + costing + bucketing/binning all run inside
                # the strategy over a fresh Orchestration
                ctx = Orchestration(buffer_meta, self.tree, step, self.seed)
                plan: LoadingPlan = self.strategy(
                    ctx, schedule=schedule, total=self.samples_per_step,
                    **self.strategy_params)
            plan_dispatched = self._dispatch(step, plan, owner)
        tel.observe("planner_plan_seconds", time.perf_counter() - t0)
        self._record_plan_metrics(plan)
        return plan_dispatched

    def _dispatch(self, step: int, plan: LoadingPlan, owner: dict):
        tel = self.telemetry
        # direct loaders: prepare planned samples (transform on the loader),
        # THEN announce realized counts + deposit, so a loader failing
        # mid-plan can never wedge a constructor on missing counts.
        by_loader: dict[str, list] = collections.defaultdict(list)
        for e in plan.entries:
            ln = owner.get(e.sample_id)
            if ln is not None:
                by_loader[ln].append(e)
        with tel.span("planner.dispatch", step=step):
            # stage 1 — prepare: one overlapped wave across loaders, so
            # the transform cost is the max over loaders, not the sum
            prepared = self._prepare_wave(by_loader)
            deposits = collections.defaultdict(list)  # bkt -> [(src,s,bin)]
            for lname, entries in by_loader.items():
                samples = prepared.get(lname)
                if samples is None:
                    continue  # supervision promotes a shadow; degrade
                by_id = {s.sample_id: s for s in samples}
                for e in entries:
                    if e.sample_id in by_id:
                        deposits[e.bucket].append(
                            (e.source, by_id[e.sample_id], e.bin))
            # stage 2 — batched ingest: expect+deposit collapsed into one
            # RPC per constructor, fanned out as a second wave
            accepted = self._ingest_wave(step, plan, deposits)
            for bucket, items in deposits.items():
                if accepted.get(bucket) is not True:
                    # unreachable, or the step is already assembled there
                    # (we are a replan after recovery); re-depositing
                    # would shadow samples a client may have consumed —
                    # first plan wins
                    continue
                per_src = collections.Counter(src for src, _, _ in items)
                for src, n in per_src.items():
                    tel.inc("planner_samples_planned_total", n,
                            source=src)
                if self.ledger is not None:
                    for src, s, b in items:
                        self.ledger.record_planned(step, s.sample_id, src,
                                                   bucket)

        self._history[step] = {
            "per_loader_ids": {ln: [e.sample_id for e in es]
                               for ln, es in by_loader.items()},
            "weights": plan.diagnostics.get("mix_weights", {}),
        }
        while len(self._history) > 64:
            self._history.popitem(last=False)
        self._diag_log.append(
            {"step": step, **{k: v for k, v in plan.diagnostics.items()
                              if k.startswith("balance")}})
        self._planned_through = step
        self._maybe_scale(plan)
        return plan

    def _prepare_wave(self, by_loader: dict) -> dict:
        """prepare() on every owning loader; fan-out unless in serial
        baseline mode.  Returns loader name -> samples (absent on
        failure — supervision handles the dead loader)."""
        targets = {ln: (self.loaders.get(ln),
                        [e.sample_id for e in entries])
                   for ln, entries in by_loader.items()}
        if self.fanout:
            fo = FanOut(telemetry=self.telemetry)
            for ln, (h, ids) in targets.items():
                if h is not None and h.alive:
                    fo.submit(ln, h, "prepare", ids, timeout=60)
            return fo.gather()
        prepared = {}
        for ln, (h, ids) in targets.items():   # perf: serial ok — baseline
            if h is None or not h.alive:
                continue
            try:
                prepared[ln] = h.call("prepare", ids, timeout=60)
            except Exception:
                continue
        return prepared

    def _ingest_wave(self, step: int, plan: LoadingPlan,
                     deposits: dict) -> dict:
        """Batched expect+deposit on EVERY constructor (a bucket with no
        items must still assemble the empty step or its clients wedge).
        Returns bucket -> True (accepted) / False (first-plan-wins
        replan skip); unreachable constructors are absent."""
        payloads = {}
        for bucket in self.constructors:
            per_src: dict = collections.defaultdict(lambda: ([], []))
            for src, s, b in deposits.get(bucket, []):
                per_src[src][0].append(s)
                per_src[src][1].append(b)
            payloads[bucket] = dict(per_src)
        if self.fanout:
            fo = FanOut(telemetry=self.telemetry)
            for bucket, h in self.constructors.items():
                fo.submit(bucket, h, "ingest", step, payloads[bucket],
                          plan.bins, timeout=30, retry=self.call_retry)
            return fo.gather()
        accepted = {}
        for bucket, h in self.constructors.items():  # perf: serial ok
            try:
                accepted[bucket] = h.call(
                    "ingest", step, payloads[bucket], plan.bins,
                    timeout=30, retry=self.call_retry)
            except Exception:
                continue   # constructor unreachable: skip its share
        return accepted

    def _record_plan_metrics(self, plan: LoadingPlan):
        """Balance/throughput gauges derived from the emitted plan."""
        tel = self.telemetry
        if not tel.enabled:
            return
        tel.inc("planner_steps_planned_total")
        tel.set_gauge("planner_planned_through",
                      float(self._planned_through))
        # how far ahead of the consumer the pipeline is running; 0 means
        # planning is on the critical path (cold start / fell behind)
        tel.set_gauge("planner_prefetch_depth",
                      float(self._planned_through - self._last_requested))
        bal = plan.diagnostics.get("balance:main") or {}
        loads = bal.get("bucket_loads") or []
        for bucket, load in enumerate(loads):
            tel.set_gauge("plan_bucket_load", float(load),
                          bucket=bucket)
        if "imbalance" in bal:
            tel.set_gauge("plan_imbalance", float(bal["imbalance"]))

    # -- dynamic mixture scaling (§5.2) ---------------------------------------
    def _maybe_scale(self, plan: LoadingPlan):
        weights = plan.diagnostics.get("mix_weights", {})
        if not weights:
            return
        base = 1.0 / max(len(weights), 1)
        for src, w in weights.items():
            ema = self._weight_ema.get(src, base)
            ema = 0.8 * ema + 0.2 * w
            self._weight_ema[src] = ema
            if ema > self.scale_threshold * base:
                self._over_count[src] += 1
                self._under_count[src] = 0
            elif ema < base / self.scale_threshold:
                self._under_count[src] += 1
                self._over_count[src] = 0
            else:
                self._over_count[src] = 0
                self._under_count[src] = 0
            if self._over_count[src] >= self.scale_patience:
                self._over_count[src] = -self.scale_patience  # cooldown
                self._scale_events.append(
                    {"step": plan.step, "source": src, "dir": "up",
                     "ema": ema})
                if self._scale_cb:
                    self._scale_cb(src, "up")
            if self._under_count[src] >= self.scale_patience:
                self._under_count[src] = -self.scale_patience
                self._scale_events.append(
                    {"step": plan.step, "source": src, "dir": "down",
                     "ema": ema})
                if self._scale_cb:
                    self._scale_cb(src, "down")

    # -- metrics feedback -------------------------------------------------------
    def observe(self, step: int, metrics: dict):
        self.schedule.observe(step, metrics)

    # -- introspection ----------------------------------------------------------
    def diagnostics(self) -> list[dict]:
        return list(self._diag_log)

    def scale_events(self) -> list[dict]:
        return list(self._scale_events)

    def degraded_log(self) -> list[dict]:
        """Steps where the mixture routed around broken sources."""
        return list(self._degraded_log)

    def planned_through(self) -> int:
        return self._planned_through

    def history_window(self) -> dict:
        return {s: h["per_loader_ids"] for s, h in self._history.items()}

    def memory_bytes(self) -> int:
        return len(pickle.dumps(self._history)) \
            + len(pickle.dumps(self._diag_log[-32:]))

    # -- checkpointing -------------------------------------------------------
    def checkpoint_state(self) -> dict:
        return {
            "planned_through": self._planned_through,
            "schedule": pickle.dumps(self.schedule),
            "weight_ema": dict(self._weight_ema),
            "history": pickle.dumps(self._history),
        }

    def restore_state(self, state: dict):
        self._planned_through = state["planned_through"]
        self.schedule = pickle.loads(state["schedule"])
        self._weight_ema = dict(state["weight_ema"])
        self._history = pickle.loads(state["history"])
        # invalidate prefetched plans past the restored step: the dead
        # incarnation may have planned ahead of this checkpoint, but this
        # incarnation must not trust (or replay) plans it cannot prove —
        # ensure_planned replans forward and the constructors' first-plan-
        # wins ingest keeps already-assembled steps authoritative
        for s in [s for s in self._history if s > self._planned_through]:
            del self._history[s]
        self._replanned = set()
        self._last_requested = min(self._last_requested,
                                   self._planned_through)

    def capture_cut(self, include_actors: bool = True) -> dict:
        """One crash-consistent cut of the data plane, taken BETWEEN plan
        steps on this mailbox thread: prepare/ingest waves are gathered
        synchronously inside ``_plan_one``, so when this method runs every
        loader has prepared — and every constructor has ingested — exactly
        the steps in this planner's history, nothing more.  Blobs cut here
        can therefore be replayed forward on resume without divergence
        (the bug a checkpoint taken from the Overlord thread has: the
        plan-ahead pipeline races it).  ``include_actors=False`` captures
        the cheap planner+ledger slice only (differential frequency)."""
        cut = {"frontier": self._planned_through,
               "planner": self.checkpoint_state(),
               "actors": {},
               "ledger": self.ledger.snapshot()
               if self.ledger is not None else None}
        if not include_actors:
            return cut
        handles = {n: h for n, h in self.loaders.items() if h.alive}
        handles.update({f"constructor:{b}": h
                        for b, h in self.constructors.items() if h.alive})
        if self.fanout:
            fo = FanOut(telemetry=self.telemetry)
            for name, h in handles.items():
                fo.submit(name, h, "checkpoint_state", timeout=30)
            cut["actors"] = fo.gather()
        else:
            for name, h in handles.items():  # perf: serial ok — baseline
                try:
                    cut["actors"][name] = h.call("checkpoint_state",
                                                 timeout=30)
                except Exception:
                    continue
        return cut

    def rollback_to(self, step: int):
        """Discard plan state beyond ``step`` (job-level resume).  The
        checkpointed planner may have planned AHEAD of the manifest step
        (plan-ahead prefetch); those steps' constructor deposits died with
        the process, and replaying loaders through them would consume
        buffer samples the deterministic replan needs — so resume rolls
        the frontier back to the manifest step first and replans forward
        from the restored buffers."""
        if step >= self._planned_through:
            return
        for s in [s for s in self._history if s > step]:
            del self._history[s]
        self._planned_through = step
        self._last_requested = min(self._last_requested, step)
        self._replanned = set()
