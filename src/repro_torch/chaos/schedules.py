"""Seeded fault schedules: the reproducible timeline the injector drives.

A ``FaultSchedule`` is an ordered list of ``FaultEvent``s pinned to
training steps.  Schedules are either generated deterministically from a
seed (same seed => byte-identical schedule, the property the chaos soak
asserts) or loaded from a JSON file:

    {"version": 1, "seed": 1234,
     "events": [{"step": 7, "kind": "io_error", "target": 1,
                 "params": {"reads": 3}}, ...]}

``target`` is an index resolved against the sorted list of primary
(non-shadow) loader names at injection time, so a schedule stays valid
across runs with different loader partitionings.
"""
from __future__ import annotations

import dataclasses
import json
import random
from typing import Iterable, Optional

# kinds the in-process supervisor absorbs without losing the Overlord;
# generate() draws from these by default so pre-existing seeded
# timelines stay byte-identical
DEFAULT_KINDS = ("crash_loader", "crash_planner", "hang", "slow",
                 "io_error", "corrupt")
# "process_death" tears down the WHOLE ActorRuntime mid-step; recovery
# comes from the on-disk manifest via Overlord.resume (the injector
# requires a resume_factory to accept such schedules)
KINDS = DEFAULT_KINDS + ("process_death",)

# deterministic parameter menus per kind (drawn by the seeded generator);
# kept small so soak tests stay fast
_PARAM_MENU = {
    "hang": [{"seconds": 0.1}, {"seconds": 0.2}, {"seconds": 0.3}],
    "slow": [{"calls": 2, "delay": 0.02}, {"calls": 4, "delay": 0.03}],
    "io_error": [{"reads": 2}, {"reads": 4}, {"reads": 6}],
    "corrupt": [{"samples": 2}, {"samples": 4}, {"samples": 6}],
    "crash_loader": [{}],
    "crash_planner": [{}],
    "process_death": [{}],
}


@dataclasses.dataclass(frozen=True, order=True)
class FaultEvent:
    step: int
    kind: str
    target: int = 0              # loader index (ignored for planner kinds)
    params: tuple = ()           # sorted ((key, value), ...) — hashable

    def param_dict(self) -> dict:
        return dict(self.params)

    def as_dict(self) -> dict:
        return {"step": self.step, "kind": self.kind,
                "target": self.target, "params": self.param_dict()}

    @classmethod
    def from_dict(cls, d: dict) -> "FaultEvent":
        return cls(step=int(d["step"]), kind=str(d["kind"]),
                   target=int(d.get("target", 0)),
                   params=tuple(sorted(d.get("params", {}).items())))


class FaultSchedule:
    def __init__(self, events: Iterable[FaultEvent],
                 seed: Optional[int] = None):
        self.events: list[FaultEvent] = sorted(events)
        self.seed = seed
        for ev in self.events:
            if ev.kind not in KINDS:
                raise ValueError(f"unknown fault kind {ev.kind!r} "
                                 f"(known: {KINDS})")

    def events_at(self, step: int) -> list[FaultEvent]:
        return [ev for ev in self.events if ev.step == step]

    def kinds(self) -> set[str]:
        return {ev.kind for ev in self.events}

    def signature(self) -> tuple:
        """Stable value equal iff two schedules are the same timeline."""
        return tuple((ev.step, ev.kind, ev.target, ev.params)
                     for ev in self.events)

    def __len__(self) -> int:
        return len(self.events)

    def __eq__(self, other) -> bool:
        return isinstance(other, FaultSchedule) \
            and self.signature() == other.signature()

    # -- generation -------------------------------------------------------
    @classmethod
    def generate(cls, seed: int, steps: int, rate: float = 0.12,
                 kinds: tuple = DEFAULT_KINDS, n_targets: int = 16,
                 warmup: int = 5,
                 ensure: tuple = ("crash_loader", "corrupt", "io_error"),
                 ) -> "FaultSchedule":
        """Deterministic schedule: each step after ``warmup`` draws a
        fault with probability ``rate``.  Kinds in ``ensure`` are
        guaranteed to appear at least once (inserted at deterministic
        steps if the random draw missed them), so any seed satisfies the
        soak's coverage requirements."""
        rng = random.Random(seed)
        events = []
        for step in range(warmup, steps):
            if rng.random() >= rate:
                continue
            kind = kinds[rng.randrange(len(kinds))]
            menu = _PARAM_MENU[kind]
            params = menu[rng.randrange(len(menu))]
            events.append(FaultEvent(
                step=step, kind=kind,
                target=rng.randrange(max(n_targets, 1)),
                params=tuple(sorted(params.items()))))
        present = {ev.kind for ev in events}
        missing = [k for k in ensure if k not in present]
        for i, kind in enumerate(missing):
            # spread guaranteed kinds across the middle of the run
            step = warmup + ((steps - warmup) * (i + 1)) // (len(missing) + 1)
            params = _PARAM_MENU[kind][0]
            events.append(FaultEvent(
                step=min(step, steps - 1), kind=kind,
                target=i % max(n_targets, 1),
                params=tuple(sorted(params.items()))))
        return cls(events, seed=seed)

    @classmethod
    def process_death_soak(cls, seed: int, steps: int, deaths: int = 3,
                           noise_rate: float = 0.08, warmup: int = 5,
                           n_targets: int = 16) -> "FaultSchedule":
        """Deterministic schedule for the durable-recovery soak: ``deaths``
        whole-process deaths spread evenly across the run, plus latency-
        only background noise (hang/slow).  Data-perturbing kinds
        (io_error/corrupt/crashes) are deliberately EXCLUDED — they change
        buffer state nondeterministically across incarnations, and this
        soak's exactly-once verdict requires the resumed replan to re-pick
        the same samples the dead incarnation planned."""
        rng = random.Random(seed)
        deaths = max(int(deaths), 1)
        events = []
        span = max(steps - warmup, deaths)
        for i in range(deaths):
            step = warmup + (span * (2 * i + 1)) // (2 * deaths)
            events.append(FaultEvent(step=min(step, steps - 1),
                                     kind="process_death"))
        death_steps = {ev.step for ev in events}
        for step in range(warmup, steps):
            if step in death_steps or rng.random() >= noise_rate:
                continue
            kind = ("hang", "slow")[rng.randrange(2)]
            menu = _PARAM_MENU[kind]
            events.append(FaultEvent(
                step=step, kind=kind,
                target=rng.randrange(max(n_targets, 1)),
                params=tuple(sorted(menu[rng.randrange(len(menu))]
                                    .items()))))
        return cls(events, seed=seed)

    # -- file format ------------------------------------------------------
    def save(self, path: str):
        with open(path, "w", encoding="utf-8") as f:
            json.dump({"version": 1, "seed": self.seed,
                       "events": [ev.as_dict() for ev in self.events]},
                      f, indent=2)

    @classmethod
    def load(cls, path: str) -> "FaultSchedule":
        with open(path, encoding="utf-8") as f:
            doc = json.load(f)
        if doc.get("version") != 1:
            raise ValueError(f"unsupported fault-schedule version "
                             f"{doc.get('version')!r} in {path}")
        return cls([FaultEvent.from_dict(d) for d in doc["events"]],
                   seed=doc.get("seed"))
