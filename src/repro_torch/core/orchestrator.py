"""Overlord: the end-to-end public API of the data plane.

Wires together: auto-partitioned Source Loaders (+hot shadows), per-bucket
Data Constructors, the central Planner, trainer clients with prefetch, the
checkpoint store with differential frequencies, and the mixture-driven
AutoScaler.  This is the object launch/train.py and the examples use.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, Optional

import numpy as np

from repro_torch.core.actors import ActorRuntime
from repro_torch.core.autoscale import (
    LoaderConfig, MixtureScaler, PartitionLimits, SourceProfile,
    auto_partition,
)
from repro_torch.core.client import TrainerClient
from repro_torch.core.constructor import DataConstructor
from repro_torch.core.fault import CheckpointStore, ShadowManager
from repro_torch.core.mixing import MixSchedule, StaticSchedule
from repro_torch.core.placetree import ClientPlaceTree
from repro_torch.core.planner import Planner
from repro_torch.core.resilience import (
    CircuitBreaker, DeadLetterQueue, RetryPolicy,
)
from repro_torch.core.source_loader import SourceLoader
from repro_torch.core.strategies import STRATEGIES
from repro_torch.data.storage import SourceReader
from repro_torch.telemetry import (
    Telemetry, chrome_trace, render_prometheus, write_chrome_trace,
)


@dataclasses.dataclass
class OverlordConfig:
    seq_len: int = 512
    rows_per_microbatch: int = 4      # packed rows per bucket per bin
    n_bins: int = 2                   # microbatches per bucket
    samples_per_step: int = 0         # 0 -> auto from capacity
    strategy: str = "backbone_balance"
    strategy_params: dict = dataclasses.field(default_factory=dict)
    prefetch: int = 2
    # pipelined planning (docs/PERFORMANCE.md; validated by CFG310):
    # plan_ahead=N keeps N steps planned beyond the newest fetch so
    # get_batch never waits on the planner in steady state; 0 restores
    # the fully demand-driven serial path.  fanout_rpc=False falls back
    # to one-RPC-at-a-time planning (the measured baseline in
    # benchmarks/orchestration.run_pipeline).
    plan_ahead: int = 2
    fanout_rpc: bool = True
    buffer_target: int = 256         # loader read-buffer depth (records)
    auto_partition: bool = True
    limits: PartitionLimits = dataclasses.field(
        default_factory=PartitionLimits)
    shadows: bool = True
    checkpoint_dir: Optional[str] = None
    planner_ckpt_every: int = 1
    loader_ckpt_every: int = 8
    restore_delay_s: float = 0.0     # simulated persistent-store latency
    # durable job recovery (docs/FAULT_TOLERANCE.md; validated by CFG311):
    # with checkpoint_dir set, every manifest_every-th step_done commits a
    # crash-consistent epoch manifest (blobs + delivery ledger) that
    # Overlord.resume() restarts from; keep_epochs old epochs are retained
    # for corruption fallback before GC reclaims them
    manifest_every: int = 1
    keep_epochs: int = 3
    vocab_size: int = 50_000
    seed: int = 0
    fill_factor: float = 0.6          # packing headroom
    # resilience (docs/FAULT_TOLERANCE.md; validated by CFG309)
    retry: RetryPolicy = dataclasses.field(default_factory=RetryPolicy)
    breaker_failures: int = 3         # consecutive read failures -> open
    breaker_cooldown_s: float = 0.25  # open -> half-open probe delay
    dlq_capacity: int = 4096          # quarantine depth (oldest evicted)
    ledger: bool = False              # per-sample delivery accounting
    # unified telemetry plane (docs/TELEMETRY.md)
    telemetry: bool = True            # metrics + trace spans
    telemetry_max_spans: int = 65536  # bounded span retention


class Overlord:
    def __init__(self, source_paths: dict[str, str],
                 tree: ClientPlaceTree, schedule: MixSchedule,
                 cfg: OverlordConfig = OverlordConfig(),
                 validate: bool = True):
        self.paths = dict(source_paths)
        self.tree = tree
        self.schedule = schedule
        self.cfg = cfg
        # static analysis before anything is spawned: a bad composition
        # fails here with findings instead of hanging the first step
        # (docs/ANALYSIS.md; disable with validate=False)
        self.analysis = None
        if validate:
            from repro_torch.analysis import AnalysisError, validate_launch
            self.analysis = validate_launch(
                cfg, tree, n_sources=len(self.paths))
            if not self.analysis.ok:
                raise AnalysisError(self.analysis)
        self.telemetry = Telemetry(enabled=cfg.telemetry,
                                   max_spans=cfg.telemetry_max_spans,
                                   seed=cfg.seed)
        self.runtime = ActorRuntime(telemetry=self.telemetry)
        self.store = CheckpointStore(cfg.checkpoint_dir,
                                     cfg.planner_ckpt_every,
                                     cfg.loader_ckpt_every,
                                     cfg.restore_delay_s,
                                     keep_epochs=cfg.keep_epochs)
        self.dlq = DeadLetterQueue(cfg.dlq_capacity)
        self.ledger = None
        if cfg.ledger:
            from repro_torch.chaos.ledger import DeliveryLedger
            self.ledger = DeliveryLedger()
        self.loaders: dict[str, object] = {}
        self.constructors: dict[int, object] = {}
        self.clients: dict[int, TrainerClient] = {}
        self.planner = None
        self._planner_args = None
        self.shadow_mgr: Optional[ShadowManager] = None
        self.scaler: Optional[MixtureScaler] = None
        self._loader_cfgs: dict[str, LoaderConfig] = {}
        self._started = False
        self._lock = threading.Lock()
        self._nudged_to = -1      # highest plan-ahead target cast so far
        self._delivered_ids: set = set()   # unique data-role sample ids
        self.recovery_log: list[dict] = []
        self.resume_report: Optional[dict] = None

    # ----------------------------------------------------------- profiles
    def _profile_sources(self) -> list[SourceProfile]:
        profs = []
        for name, path in self.paths.items():
            with SourceReader(path) as r:
                recs = r.read(8)
                cost = float(np.mean([rc["transform_cost"] for rc in recs]))
                mem = r.access_state_bytes
            profs.append(SourceProfile(name, cost, mem,
                                       1.0 / max(len(self.paths), 1)))
        return profs

    # -------------------------------------------------------------- start
    def start(self, spawn_clients: bool = True):
        """Bring up the data plane.  ``spawn_clients=False`` defers the
        trainer clients (resume uses this: clients start prefetching the
        moment they exist, and a client prefetching step 0 against a
        restored-but-not-yet-replayed plane would corrupt it)."""
        assert not self._started
        cfg = self.cfg
        if cfg.checkpoint_dir:
            # claim the job fence FIRST: from here on, any zombie
            # incarnation of a previous process is locked out of commits
            self.store.acquire_fence()
        if cfg.samples_per_step == 0:
            nb = self.tree.buckets(
                cfg.strategy_params.get("axis", "DP"))
            capacity = nb * cfg.n_bins * cfg.rows_per_microbatch \
                * cfg.seq_len
            # rough mean tokens/sample for sizing
            cfg.samples_per_step = max(
                nb * cfg.n_bins,
                int(capacity * cfg.fill_factor / 96))

        # loaders (phase-1 auto-partitioning)
        if cfg.auto_partition:
            lcfgs = auto_partition(self._profile_sources(), cfg.limits)
        else:
            lcfgs = [LoaderConfig(n, 0, 1, 1) for n in self.paths]
        for lc in lcfgs:
            h = self.runtime.spawn(lc.actor_name, self._make_loader(lc))
            self.loaders[lc.actor_name] = h
            self._loader_cfgs[lc.actor_name] = lc

        # constructors: one per bucket at the distribute axis.  The ready
        # queue must hold every step between the slowest consumer and the
        # plan-ahead frontier, or prefetched-but-unconsumed steps get
        # evicted (and replanned — duplicating delivery)
        axis = cfg.strategy_params.get("axis", "DP")
        queue_depth = max(4, cfg.plan_ahead + cfg.prefetch + 4)
        for b in range(self.tree.buckets(axis)):
            h = self.runtime.spawn(
                f"constructor:{b}",
                DataConstructor(b, self.tree, cfg.seq_len,
                                cfg.rows_per_microbatch, cfg.n_bins,
                                queue_depth=queue_depth,
                                ledger=self.ledger,
                                telemetry=self.telemetry))
            self.constructors[b] = h

        # planner
        strategy = STRATEGIES[cfg.strategy]
        sparams = dict(cfg.strategy_params)
        sparams.setdefault("n_bins", cfg.n_bins)
        self._planner_args = dict(
            tree=self.tree, schedule=self.schedule, strategy=strategy,
            strategy_params=sparams,
            samples_per_step=cfg.samples_per_step, seed=cfg.seed,
            ledger=self.ledger, telemetry=self.telemetry,
            plan_ahead=cfg.plan_ahead, fanout=cfg.fanout_rpc)
        self.planner = self.runtime.spawn(
            "planner", Planner(loaders=dict(self.loaders),
                               constructors=dict(self.constructors),
                               **self._planner_args))

        # shadows + supervision
        if cfg.shadows:
            self.shadow_mgr = ShadowManager(self.runtime, self._make_shadow)
            for name in list(self.loaders):
                self.shadow_mgr.ensure_shadow(name)
        self.runtime.on_failure(self._on_actor_failure)

        # online mixture scaler
        self.scaler = MixtureScaler(
            self.runtime, self.paths,
            register=self._register_loader,
            unregister=self._unregister_loader,
            loader_factory=self._make_loader)
        self.planner.call("set_scale_callback", self.scaler.on_trigger,
                          retry=self.cfg.retry)

        # trainer clients
        if spawn_clients:
            self._spawn_clients(start_step=0)
        self._started = True
        return self

    def _spawn_clients(self, start_step: int) -> None:
        for rank in range(self.tree.world):
            self.clients[rank] = TrainerClient(
                rank, self._fetch_view, prefetch=self.cfg.prefetch,
                start_step=start_step)

    def _make_loader(self, lc: LoaderConfig) -> SourceLoader:
        return SourceLoader(lc.source, self.paths[lc.source],
                            (lc.shard_index, lc.shard_count), lc.workers,
                            buffer_target=self.cfg.buffer_target,
                            vocab_size=self.cfg.vocab_size,
                            seed=self.cfg.seed,
                            retry=self.cfg.retry,
                            breaker=CircuitBreaker(
                                self.cfg.breaker_failures,
                                self.cfg.breaker_cooldown_s),
                            dlq=self.dlq,
                            telemetry=self.telemetry)

    def _make_shadow(self, name: str) -> SourceLoader:
        return self._make_loader(self._loader_cfgs[name])

    # ------------------------------------------------------ loader churn
    def _register_loader(self, name: str, handle):
        with self._lock:
            self.loaders[name] = handle
            parts = name.split(":")
            idx, cnt = parts[2].split("of")
            self._loader_cfgs[name] = LoaderConfig(
                parts[1], int(idx), int(cnt), 2)
        # cast, not call: register/unregister run inside the scale
        # callback, which the planner fires ON its own mailbox thread —
        # a synchronous call back into the planner would self-deadlock
        # (the ACT503 pattern).  Mailbox FIFO still orders the update
        # before any later plan.
        try:
            self.planner.cast("set_loaders", dict(self.loaders))
        except Exception:
            pass   # planner mid-recovery re-syncs the loader map itself
        if self.shadow_mgr:
            self.shadow_mgr.ensure_shadow(name)

    def _unregister_loader(self, name: str):
        with self._lock:
            self.loaders.pop(name, None)
        try:
            self.planner.cast("set_loaders", dict(self.loaders))
        except Exception:
            pass   # planner mid-recovery re-syncs the loader map itself

    # ------------------------------------------------------- supervision
    def _on_actor_failure(self, name: str, handle):
        t0 = time.time()
        if name == "planner":
            self._recover_planner()
        elif name.startswith("loader:") and "::shadow" not in name:
            self._recover_loader(name)
        self.recovery_log.append(
            {"actor": name, "recovery_s": time.time() - t0,
             "time": time.time()})

    def _recover_planner(self):
        ckpt = self.store.load("planner")
        self.planner = self.runtime.spawn(
            "planner", Planner(loaders=dict(self.loaders),
                               constructors=dict(self.constructors),
                               **self._planner_args))
        if ckpt:
            self.planner.call("restore_state", ckpt["state"],
                              retry=self.cfg.retry)
        self.planner.call("set_scale_callback", self.scaler.on_trigger,
                          retry=self.cfg.retry)

    def _replay_since(self, handle, name: str, since_step: int):
        """Replay the plan history window > since_step against a restored
        loader so already-planned samples are consumed, not re-served."""
        try:
            hist = self.planner.call("history_window", timeout=10,
                                     retry=self.cfg.retry)
        except Exception:
            return   # planner down too; its own recovery replans the gap
        replay = [ids.get(name, []) for s, ids in sorted(hist.items())
                  if s > since_step]
        replay = [r for r in replay if r]
        if replay:
            try:
                handle.call("replay", replay, timeout=30,
                            retry=self.cfg.retry)
            except Exception:
                pass   # degraded: at worst the ledger flags duplicates

    def _recover_loader(self, name: str):
        promoted = None
        if self.shadow_mgr:
            promoted = self.shadow_mgr.promote(name)
        if promoted is not None:
            with self._lock:
                self.loaders[name] = promoted
            # the shadow mirrors state as of its last successful sync;
            # plans issued after that already delivered samples the
            # shadow still buffers — replay them forward or they would
            # be delivered twice
            self._replay_since(promoted, name,
                               self.shadow_mgr.synced_step(name))
        else:
            # cold path: restore from checkpoint + replay plan history
            h = self.runtime.spawn(name, self._make_loader(
                self._loader_cfgs[name]))
            ckpt = self.store.load(name)
            if ckpt:
                try:
                    h.call("restore_state", ckpt["state"],
                           retry=self.cfg.retry)
                except Exception:
                    pass   # fresh loader state; replay still converges
                self._replay_since(h, name, ckpt["step"])
            with self._lock:
                self.loaders[name] = h
        try:
            self.planner.call("set_loaders", dict(self.loaders),
                              retry=self.cfg.retry)
        except Exception:
            pass   # planner recovery re-syncs the loader map itself
        if self.shadow_mgr:
            self.shadow_mgr.ensure_shadow(name)

    # ---------------------------------------------------------- data path
    def _bucket_of(self, rank: int, axis: str) -> int:
        view = self.tree.client_view(rank, axis)
        return min(view.dp_index, max(self.constructors)) \
            if self.constructors else 0

    def _nudge_planner(self, step: int) -> None:
        """Keep the plan-ahead window full: a non-blocking cast moves the
        planner's frontier to ``step + plan_ahead`` while the trainer
        consumes ``step``.  Monotonic + deduplicated so each target is
        cast at most once across ranks and prefetch threads."""
        target = step + self.cfg.plan_ahead
        with self._lock:
            if target <= self._nudged_to:
                return
            self._nudged_to = target
        try:
            self.planner.cast("advance_to", target)
        except Exception:
            pass   # planner mid-recovery: the next fetch re-nudges

    def _fetch_view(self, step: int, rank: int) -> Optional[dict]:
        axis = self.cfg.strategy_params.get("axis", "DP")
        bucket = self._bucket_of(rank, axis)
        ch = self.constructors.get(bucket)
        if ch is None:
            return None
        out = None
        if self.cfg.plan_ahead > 0:
            # fast path: a prefetched step is already assembled in the
            # constructor — no planner round-trip on the critical path
            try:
                out = ch.call("get_view", step, rank, axis)
            except Exception:
                out = None
        if out is None:
            # cold start / replan / pipelining off: block on the planner
            try:
                self.planner.call("ensure_planned", step, timeout=120)
            except Exception:
                return None  # planner down: prefetch buffer rides through
            try:
                out = ch.call("get_view", step, rank, axis)
                if out is None:
                    # planner died mid-plan: the step is 'planned' but
                    # lost — replan it once (fresh buffered data; see
                    # Planner.replan)
                    if self.planner.call("replan", step):
                        out = ch.call("get_view", step, rank, axis)
            except Exception:
                return None
        if out is not None and self.cfg.plan_ahead > 0:
            self._nudge_planner(step)
        return out

    def get_batch(self, step: int, rank: int, timeout: float = 60.0) -> dict:
        tel = self.telemetry
        t0 = time.perf_counter()
        with tel.span("overlord.get_batch", step=step, rank=rank):
            view = self.clients[rank].get(step, timeout=timeout)
            if view.get("role") == "data":
                ids = {sid for b in view["bins"] for row in b.doc_ids
                       for sid in row}
                if self.ledger is not None:
                    axis = self.cfg.strategy_params.get("axis", "DP")
                    self.ledger.record_delivered(
                        step, rank, self._bucket_of(rank, axis), ids)
                if tel.enabled:
                    tokens = int(sum((b.segment_ids > 0).sum()
                                     for b in view["bins"]))
                    tel.inc("delivered_views_total", 1.0, rank=rank)
                    tel.inc("rank_tokens_total", tokens, rank=rank)
                    with self._lock:
                        new = ids - self._delivered_ids
                        self._delivered_ids |= new
                    if new:
                        tel.inc("delivered_samples_total", len(new))
        tel.observe("get_batch_seconds", time.perf_counter() - t0,
                    rank=rank)
        return view

    def step_done(self, step: int, metrics: Optional[dict] = None):
        """Call once per completed train step: checkpoints + shadow sync.
        ``metrics`` (e.g. loss, grad_norm) feed the adaptive mixture
        schedule AND land in the registry as ``train_metric`` gauges."""
        tel = self.telemetry
        with tel.span("overlord.step_done", step=step):
            if metrics:
                try:
                    self.planner.cast("observe", step, metrics)
                except Exception:
                    pass   # planner mid-recovery: metrics still recorded
                if tel.enabled:
                    for k, v in metrics.items():
                        if isinstance(v, (int, float)) \
                                and not isinstance(v, bool):
                            tel.set_gauge("train_metric", float(v),
                                          metric=k)
            if tel.enabled:
                tel.inc("train_steps_total")
                tel.set_gauge("train_step", float(step))
            self.store.maybe_save("planner", "planner", step, self.planner)
            for name, h in list(self.loaders.items()):
                self.store.maybe_save("loader", name, step, h)
                if self.shadow_mgr:
                    self.shadow_mgr.sync(name, h, step=step)
            # constructor state is tiny (counters), so it rides the
            # planner's every-step cadence rather than the loaders'
            for b, h in list(self.constructors.items()):
                self.store.maybe_save("planner", f"constructor:{b}",
                                      step, h)
            if self.ledger is not None:
                # mirror quarantines so verify() accounts them (idempotent)
                for it in self.dlq.items():
                    self.ledger.record_quarantined(
                        it["sample_id"], it["source"], it["reason"])
            if self.cfg.checkpoint_dir \
                    and step % max(self.cfg.manifest_every, 1) == 0:
                # atomic commit point for job-level recovery.  The cut is
                # captured ON the planner's mailbox thread, BETWEEN plans:
                # blobs saved from this thread would race the plan-ahead
                # pipeline and silently include pops for steps beyond the
                # manifest's label (docs/FAULT_TOLERANCE.md runbook).
                # Actor state rides the differential loader cadence; the
                # planner slice + ledger commit every manifest_every step.
                with tel.span("recovery.commit_manifest", step=step):
                    include = step % max(self.cfg.loader_ckpt_every,
                                         1) == 0
                    epoch = None
                    try:
                        cut = self.planner.call(
                            "capture_cut", include, timeout=60,
                            retry=self.cfg.retry)
                        epoch = self.store.commit_cut(step, cut)
                    except Exception:
                        pass   # planner mid-recovery: next step commits
                if tel.enabled and epoch is not None:
                    tel.inc("recovery_manifests_total")
                    tel.set_gauge("recovery_committed_epoch", float(epoch))

    # ------------------------------------------------------ job recovery
    def resume(self, store: Optional[CheckpointStore] = None):
        """Restart the dataloader JOB from the newest consistent on-disk
        epoch (§6.1 deployment story): acquire the fence (locking any
        zombie incarnation out of future commits), rebuild the plane with
        clients deferred, restore planner/loaders/constructors/ledger from
        the manifest, roll the planner back to the manifest step, replay
        each loader's plan-history gap, then start clients at the first
        undelivered step.  Falls back to a cold ``start()`` when no
        consistent epoch exists."""
        assert not self._started
        t0 = time.perf_counter()
        tel = self.telemetry
        if store is not None:
            self.store = store
        with tel.span("recovery.resume"):
            token = self.store.acquire_fence()
            with tel.span("recovery.load_manifest"):
                man = self.store.latest_manifest()
            if man is None:
                self.start()
                self.resume_report = {
                    "cold_start": True, "epoch": None, "step": -1,
                    "fence_token": token, "restored": [], "replayed_steps": 0}
                return self
            step = int(man["step"])
            # R: the recovery line.  ``step`` is the delivery frontier
            # (last completed train step); ``frontier`` is the actor
            # cut's plan frontier.  Steps in (step, R] are served from
            # the restored constructor views — their samples were popped
            # from the loader buffers before the cut, so they cannot be
            # replanned, only restored.  Steps beyond R are replanned
            # deterministically from the restored buffers.
            rline = max(step, int(man.get("frontier", step)))
            self.store.adopt_cut(man)
            self.start(spawn_clients=False)
            restored = []
            with tel.span("recovery.restore", step=step,
                          epoch=man["epoch"]):
                ck = self.store.load_from_manifest(man, "planner")
                if ck is not None:
                    self.planner.call("restore_state", ck["state"],
                                      retry=self.cfg.retry)
                    restored.append("planner")
                # discard plan-ahead state beyond the recovery line:
                # those steps' deposits died with the old process and
                # will be replanned from the restored buffers
                self.planner.call("rollback_to", rline,
                                  retry=self.cfg.retry)
                loader_since: dict[str, int] = {}
                for name, h in list(self.loaders.items()):
                    ck = self.store.load_from_manifest(man, name)
                    if ck is None:
                        continue
                    try:
                        # perf: serial ok — recovery path, not step path
                        h.call("restore_state", ck["state"],
                               retry=self.cfg.retry)
                        restored.append(name)
                        loader_since[name] = int(ck["step"])
                    except Exception:
                        pass   # fresh loader; replay from -1 still converges
                for b, h in list(self.constructors.items()):
                    ck = self.store.load_from_manifest(
                        man, f"constructor:{b}")
                    if ck is None:
                        continue
                    try:
                        # perf: serial ok — recovery path, not step path
                        h.call("restore_state", ck["state"],
                               retry=self.cfg.retry)
                        restored.append(f"constructor:{b}")
                    except Exception:
                        pass
                if self.ledger is not None:
                    snap = self.store.load_ledger(man)
                    if snap is not None:
                        self.ledger.restore(snap)
                        with self._lock:
                            self._delivered_ids = \
                                self.ledger.delivered_ids()
                        restored.append("ledger")
            replayed = 0
            with tel.span("recovery.replay", step=step):
                for name, h in list(self.loaders.items()):
                    # perf: serial ok — recovery path
                    since = loader_since.get(name, -1)
                    self._replay_since(h, name, since)
                    replayed = max(replayed, rline - since)
            self._spawn_clients(start_step=step + 1)
        elapsed = time.perf_counter() - t0
        if tel.enabled:
            tel.inc("recovery_resumes_total")
            tel.set_gauge("recovery_epoch", float(man["epoch"]))
            tel.set_gauge("recovery_replayed_steps", float(replayed))
            tel.observe("recovery_resume_seconds", elapsed)
        self.resume_report = {
            "cold_start": False, "epoch": man["epoch"], "step": step,
            "frontier": rline, "fence_token": token, "restored": restored,
            "replayed_steps": replayed, "resume_s": elapsed}
        return self

    def simulate_process_death(self):
        """Abrupt whole-job crash: every actor killed with mail dropped,
        no supervision callbacks (the supervisor dies with the process),
        clients torn down.  The only way back is ``resume()`` on a fresh
        Overlord — exactly the process-death chaos mode's contract."""
        self.runtime.terminate()
        for c in self.clients.values():
            c.close()
        self.clients.clear()
        self._started = False

    # ------------------------------------------------------ introspection
    def memory_report(self) -> dict:
        rep = self.runtime.memory_report()
        out = {
            "loaders": sum(v for k, v in rep.items()
                           if k.startswith("loader:")
                           and "::shadow" not in k),
            "shadows": sum(v for k, v in rep.items() if "::shadow" in k),
            "constructors": sum(v for k, v in rep.items()
                                if k.startswith("constructor:")),
            "planner": rep.get("planner", 0),
        }
        out["total_ex_shadows"] = (out["loaders"] + out["constructors"]
                                   + out["planner"])
        return out

    def diagnostics(self) -> list[dict]:
        return self.planner.call("diagnostics", retry=self.cfg.retry)

    def resilience_report(self) -> dict:
        """One view over every hardening surface: checkpoint-save failures,
        shadow staleness, quarantined samples, per-source breaker state."""
        health = {}
        for name, h in list(self.loaders.items()):
            if "::shadow" in name or not h.alive:
                continue
            try:
                # perf: serial ok — operator introspection, not step path
                health[name] = h.call("health", timeout=10)
            except Exception:
                health[name] = {"source": "?", "breaker": "unreachable"}
        return {
            "checkpoints": self.store.stats(),
            "shadows": self.shadow_mgr.stats() if self.shadow_mgr else {},
            "dlq": self.dlq.stats(),
            "loaders": health,
            "recoveries": len(self.recovery_log),
        }

    # ------------------------------------------------- telemetry surfaces
    def telemetry_report(self) -> dict:
        """The unified observability view: metric snapshot + memory +
        resilience + plan diagnostics + delivery accounting, one call.
        Supersedes stitching memory_report()/diagnostics()/
        resilience_report() together by hand (those remain available)."""
        tel = self.telemetry
        if tel.enabled:
            for name, h in self.runtime.actors().items():
                if h.alive:
                    tel.set_gauge("actor_mailbox_depth",
                                  float(h.mailbox_depth), actor=name)
            dlq = self.dlq.stats()
            tel.set_gauge("dlq_held", float(dlq["held"]))
            tel.set_gauge("dlq_total", float(dlq["total"]))
        per_rank = {
            dict(key).get("rank", "?"): c.value
            for (name, key), c in tel.registry.series()["counters"].items()
            if name == "rank_tokens_total"}
        vals = list(per_rank.values())
        imbalance = (max(vals) / (sum(vals) / len(vals))
                     if vals and sum(vals) > 0 else 1.0)
        if tel.enabled and vals:
            tel.set_gauge("rank_token_imbalance", imbalance)
        try:
            diag = self.diagnostics()
        except Exception:
            diag = []
        return {
            "enabled": tel.enabled,
            "metrics": tel.snapshot(),
            "memory": self.memory_report(),
            "resilience": self.resilience_report(),
            "diagnostics": diag,
            "delivery": {
                "delivered_samples": int(tel.registry.counter_value(
                    "delivered_samples_total")),
                "per_rank_tokens": per_rank,
                "token_imbalance": imbalance,
            },
            "spans": {"finished": len(tel.tracer),
                      "dropped": tel.tracer.dropped},
        }

    def prometheus_dump(self) -> str:
        """Prometheus text exposition of the full registry."""
        return render_prometheus(self.telemetry.registry)

    def chrome_trace(self) -> dict:
        """chrome://tracing / Perfetto JSON of the finished spans."""
        return chrome_trace(self.telemetry.tracer)

    def write_chrome_trace(self, path) -> None:
        write_chrome_trace(path, self.telemetry.tracer)

    # --------------------------------------------------- fault injection
    def inject_loader_failures(self, n: int = 1):
        names = [k for k in self.loaders if "::shadow" not in k][:n]
        for name in names:
            self.loaders[name].kill()
        return names

    def inject_planner_failure(self):
        self.planner.kill()

    def shutdown(self):
        for c in self.clients.values():
            c.close()
        self.runtime.shutdown()
