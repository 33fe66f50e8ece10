"""FaultInjector: applies a seeded FaultSchedule to a live Overlord.

Wraps all three layers the paper's §6 design must survive:

  * actor runtime — ``crash_loader`` / ``crash_planner`` kill actors
    abruptly (pending mail dropped), exercising shadow promotion and
    differential-checkpoint recovery;
  * storage — ``io_error`` installs a read-fault budget into the storage
    layer's fault hook, so ``SourceReader.read`` raises TransientIOError
    and the loader's retry policy + circuit breaker absorb it;
  * data sources — ``corrupt`` poisons the next records the loader
    prepares (caught by validation, routed to the dead-letter queue),
    ``hang`` / ``slow`` wedge or delay the loader's mailbox thread.

Drive it once per training step: ``injector.on_step(step)``.  The
``timeline()`` (step, kind, resolved-target, params) is fully determined
by the schedule plus the sorted loader names, which is what the chaos
soak compares across two same-seed runs.
"""
from __future__ import annotations

import threading
import time
from typing import Callable, Optional

from repro_torch.chaos.schedules import FaultSchedule
from repro_torch.core.resilience import TransientIOError
from repro_torch.data import storage
from repro_torch.telemetry import ensure_telemetry


class FaultInjector:
    def __init__(self, overlord, schedule: FaultSchedule,
                 install_storage_hook: bool = True,
                 resume_factory: Optional[Callable[[], object]] = None):
        """``resume_factory`` () -> started-or-resumed Overlord: required
        when the schedule contains ``process_death`` events.  On such an
        event the injector tears the CURRENT overlord's runtime down
        abruptly (``simulate_process_death``) and swaps in the factory's
        fresh incarnation (which should call ``Overlord.resume()``), so
        the soak driver keeps using ``injector.ov``."""
        self.ov = overlord
        self.schedule = schedule
        self.resume_factory = resume_factory
        if "process_death" in schedule.kinds() and resume_factory is None:
            raise ValueError(
                "schedule contains process_death events; FaultInjector "
                "needs a resume_factory to bring the job back")
        self.applied: list[tuple] = []
        self.errors: list[tuple] = []
        self.resumes: list[dict] = []
        self._lock = threading.Lock()
        self._io_budget: dict[str, int] = {}   # storage path -> fail count
        self._prev_hook = None
        self._installed = False
        if install_storage_hook:
            self.install()

    # -- storage hook ------------------------------------------------------
    def install(self):
        if not self._installed:
            self._prev_hook = storage.set_fault_hook(self._storage_hook)
            self._installed = True

    def uninstall(self):
        if self._installed:
            storage.set_fault_hook(self._prev_hook)
            self._installed = False

    def _storage_hook(self, reader, n: int):
        with self._lock:
            remaining = self._io_budget.get(reader.path, 0)
            if remaining > 0:
                self._io_budget[reader.path] = remaining - 1
                raise TransientIOError(
                    f"chaos: injected read failure on {reader.path} "
                    f"({remaining - 1} left)")
        if self._prev_hook is not None:
            self._prev_hook(reader, n)

    # -- per-step drive ----------------------------------------------------
    def primary_loaders(self) -> list[str]:
        return sorted(n for n in self.ov.loaders if "::shadow" not in n)

    def on_step(self, step: int) -> list[tuple]:
        fired = []
        for ev in self.schedule.events_at(step):
            fired.append(self._apply(step, ev))
        return fired

    def _apply(self, step: int, ev) -> tuple:
        """Apply one event.  The timeline entry is recorded BEFORE the
        action: whether a kill lands on an already-dead handle is a race
        against supervision, and the timeline two same-seed runs compare
        must not depend on it.  Action failures go to ``errors``."""
        params = ev.param_dict()
        if ev.kind == "process_death":
            entry = (step, ev.kind, "job", ev.params)
        elif ev.kind == "crash_planner":
            entry = (step, ev.kind, "planner", ev.params)
        else:
            names = self.primary_loaders()
            name = names[ev.target % len(names)]
            if ev.kind in ("corrupt", "io_error"):
                # source-level faults: a corrupted or failing FILE hits
                # every shard reading it, not one loader
                entry = (step, ev.kind, self._source_of(name), ev.params)
            else:
                entry = (step, ev.kind, name, ev.params)
        self.applied.append(entry)
        tel = ensure_telemetry(getattr(self.ov, "telemetry", None))
        with tel.span("chaos.inject", step=step,
                      target=str(entry[2])) as sp:
            sp.stamp_fault(ev.kind)
            try:
                if ev.kind == "process_death":
                    # whole-job crash: runtime torn down with no
                    # supervision, then a fresh incarnation resumes from
                    # the on-disk manifest and takes over as self.ov
                    t0 = time.time()
                    self.ov.simulate_process_death()
                    self.ov = self.resume_factory()
                    self.resumes.append({
                        "step": step, "downtime_s": time.time() - t0,
                        "report": getattr(self.ov, "resume_report", None)})
                elif ev.kind == "crash_planner":
                    self.ov.inject_planner_failure()
                elif ev.kind == "crash_loader":
                    self.ov.loaders[entry[2]].kill()
                elif ev.kind == "io_error":
                    # storage-layer fault: budgeted failures on the
                    # source's backing file, seen by every reader of it
                    path = self.ov.paths[entry[2]]
                    with self._lock:
                        self._io_budget[path] = \
                            self._io_budget.get(path, 0) \
                            + int(params.get("reads", 3))
                elif ev.kind == "corrupt":
                    for n in self.primary_loaders():
                        if self._source_of(n) == entry[2]:
                            self.ov.loaders[n].cast(
                                "inject_fault", ev.kind, **params)
                else:   # hang / slow run on the one loader
                    self.ov.loaders[entry[2]].cast(
                        "inject_fault", ev.kind, **params)
            except Exception as e:   # failed injection must not stop soak
                self.errors.append(
                    (step, ev.kind, f"{type(e).__name__}: {e}"))
                sp.set_attr("inject_error", type(e).__name__)
        tel.inc("chaos_faults_injected_total", 1.0, kind=ev.kind)
        return entry

    def _source_of(self, loader_name: str) -> str:
        cfg = self.ov._loader_cfgs.get(loader_name)
        return cfg.source if cfg is not None else loader_name.split(":")[1]

    def timeline(self) -> list[tuple]:
        return list(self.applied)
