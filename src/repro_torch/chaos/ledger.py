"""DeliveryLedger: end-to-end no-loss / no-duplicate accounting.

Records every sample's journey through the data plane:

  * ``record_planned``   — the Planner deposited it into a constructor
                           for a (step, bucket),
  * ``record_delivered`` — a trainer rank actually received it from
                           ``get_batch`` (role "data" views only),
  * ``record_dropped``   — the constructor discarded it with a reason
                           (packing overflow, queue-depth eviction),
  * ``record_quarantined`` — a loader routed it to the dead-letter queue.

``verify()`` then asserts the paper's headline §6 claim under arbitrary
fault runs: every planned sample is delivered or explicitly accounted
for (zero loss), no sample is delivered in two different steps (zero
duplicates), all ranks of a bucket saw the same sample set, and nothing
quarantined ever reached a trainer.

Thread-safe: actor threads (planner, constructors) and trainer threads
write concurrently.
"""
from __future__ import annotations

import collections
import threading
from typing import Iterable, Optional


class LedgerViolation(AssertionError):
    """A no-loss / no-duplicate invariant was broken."""


class DeliveryLedger:
    def __init__(self):
        self._lock = threading.Lock()
        # sample_id -> (step, source, bucket) of the deposit
        self._planned: dict[str, tuple[int, str, int]] = {}
        # sample_id -> set of steps it was delivered in
        self._delivered: dict[str, set] = {}
        # (step, bucket) -> rank -> frozenset(sample_ids)
        self._by_rank: dict = collections.defaultdict(dict)
        self._dropped: dict[str, str] = {}        # sample_id -> reason
        self._quarantined: dict[str, str] = {}    # sample_id -> source
        self._max_delivered_step = -1

    # -- recording --------------------------------------------------------
    def record_planned(self, step: int, sample_id: str, source: str,
                       bucket: int):
        with self._lock:
            self._planned[sample_id] = (step, source, bucket)

    def record_delivered(self, step: int, rank: int, bucket: int,
                         sample_ids: Iterable[str]):
        ids = frozenset(sample_ids)
        with self._lock:
            for sid in ids:
                self._delivered.setdefault(sid, set()).add(step)
            self._by_rank[(step, bucket)][rank] = ids
            self._max_delivered_step = max(self._max_delivered_step, step)

    def record_dropped(self, step: int, sample_id: str, reason: str):
        with self._lock:
            self._dropped[sample_id] = reason

    def record_quarantined(self, sample_id: str, source: str,
                           reason: str = ""):
        with self._lock:
            self._quarantined[sample_id] = source

    # -- persistence ------------------------------------------------------
    def snapshot(self) -> dict:
        """Point-in-time copy of the full accounting state, suitable for
        pickling into a checkpoint manifest (job-level recovery: the
        resumed process must remember what was already delivered, or the
        first post-resume verify() would report phantom duplicates/loss).
        """
        with self._lock:
            return {
                "planned": dict(self._planned),
                "delivered": {k: sorted(v)
                              for k, v in self._delivered.items()},
                "by_rank": {k: {r: sorted(ids) for r, ids in v.items()}
                            for k, v in self._by_rank.items()},
                "dropped": dict(self._dropped),
                "quarantined": dict(self._quarantined),
                "max_delivered_step": self._max_delivered_step,
            }

    def restore(self, snap: dict) -> None:
        """Inverse of ``snapshot`` — replaces this ledger's state."""
        with self._lock:
            self._planned = {k: tuple(v)
                             for k, v in snap["planned"].items()}
            self._delivered = {k: set(v)
                               for k, v in snap["delivered"].items()}
            self._by_rank = collections.defaultdict(dict)
            for key, per_rank in snap["by_rank"].items():
                self._by_rank[tuple(key) if isinstance(key, (list, tuple))
                              else key] = {
                    r: frozenset(ids) for r, ids in per_rank.items()}
            self._dropped = dict(snap["dropped"])
            self._quarantined = dict(snap["quarantined"])
            self._max_delivered_step = int(snap["max_delivered_step"])

    def delivered_ids(self) -> set:
        """All sample ids any rank has ever received (resume seeds the
        Overlord's unique-delivery telemetry set from this)."""
        with self._lock:
            return set(self._delivered)

    # -- verification -----------------------------------------------------
    def verify(self, through_step: Optional[int] = None,
               strict: bool = True) -> dict:
        """Check invariants over steps <= ``through_step`` (default: the
        last step any rank consumed).  Returns a summary dict; with
        ``strict`` raises LedgerViolation on loss or duplication."""
        with self._lock:
            planned = dict(self._planned)
            delivered = {k: set(v) for k, v in self._delivered.items()}
            by_rank = {k: dict(v) for k, v in self._by_rank.items()}
            dropped = dict(self._dropped)
            quarantined = dict(self._quarantined)
            horizon = self._max_delivered_step if through_step is None \
                else through_step

        duplicates = {sid: sorted(steps)
                      for sid, steps in delivered.items() if len(steps) > 1}
        lost = []
        for sid, (step, source, bucket) in planned.items():
            if step > horizon:
                continue   # deposited but not yet due for delivery
            if sid in delivered or sid in dropped or sid in quarantined:
                continue
            lost.append((sid, step, source))
        rank_skew = []
        for (step, bucket), per_rank in by_rank.items():
            sets = set(per_rank.values())
            if len(sets) > 1:
                rank_skew.append((step, bucket,
                                  {r: sorted(s) for r, s in
                                   per_rank.items()}))
        leaked = sorted(set(delivered) & set(quarantined))

        summary = {
            "planned": len(planned),
            "delivered": len(delivered),
            "dropped": len(dropped),
            "quarantined": len(quarantined),
            "through_step": horizon,
            "lost": sorted(lost),
            "duplicates": duplicates,
            "rank_skew": rank_skew,
            "quarantine_leaks": leaked,
        }
        summary["ok"] = not (lost or duplicates or rank_skew or leaked)
        if strict and not summary["ok"]:
            problems = []
            if lost:
                problems.append(f"{len(lost)} lost sample(s): "
                                f"{sorted(lost)[:5]}")
            if duplicates:
                problems.append(f"{len(duplicates)} duplicated sample(s): "
                                f"{sorted(duplicates.items())[:5]}")
            if rank_skew:
                problems.append(f"rank skew at {len(rank_skew)} "
                                f"(step, bucket) pair(s)")
            if leaked:
                problems.append(f"{len(leaked)} quarantined sample(s) "
                                f"delivered: {leaked[:5]}")
            raise LedgerViolation("; ".join(problems))
        return summary
