"""DataConstructor actor: microbatch + parallelism transformations (§3).

One constructor per DP bucket (the data *sink* for every rank in that
bucket's parallelism group).  It aggregates Source Loader outputs for its
bucket, packs them into microbatches, and serves per-CLIENT views:
  * CP ranks get zig-zag sequence slices of the same batch,
  * PP>0 stages get metadata only,
  * TP>0 ranks get nothing when broadcast_at("TP") is active.
This is the parallelism-redundancy elimination of Figs. 6/14: each
distinct byte exists once per bucket, not once per rank.
"""
from __future__ import annotations

import threading
from typing import Optional

import numpy as np

from repro_torch.core.actors import Actor
from repro_torch.core.placetree import ClientPlaceTree
from repro_torch.data import packing
from repro_torch.data.transforms import Sample
from repro_torch.telemetry import Telemetry, ensure_telemetry


class DataConstructor(Actor):
    def __init__(self, bucket: int, tree: ClientPlaceTree, seq_len: int,
                 rows_per_microbatch: int, n_bins: int = 1,
                 queue_depth: int = 4, ledger=None,
                 telemetry: Optional[Telemetry] = None):
        self.bucket = bucket
        self.tree = tree
        self.seq_len = seq_len
        self.rows = rows_per_microbatch
        self.n_bins = n_bins
        self.queue_depth = queue_depth
        self.ledger = ledger
        self.telemetry = ensure_telemetry(telemetry)
        # step -> {"bins": [PackedBatch...], "meta": {...}}
        self._ready: dict[int, dict] = {}
        self._pending: dict[int, dict] = {}   # step -> bin -> [samples]
        self._expected: dict[int, dict] = {}  # step -> source -> count
        self._dropped = 0
        self._built_steps = 0

    # -- deposits from Source Loaders --------------------------------------
    def expect(self, step: int, per_source_counts: dict,
               n_bins: int) -> bool:
        """Open a step for deposits.  Returns False when the step is
        already assembled here — a replanning planner (post-recovery) must
        not overwrite a batch a client may have consumed (first plan
        wins)."""
        if step in self._ready:
            return False
        self._expected[step] = dict(per_source_counts)
        self.n_bins = n_bins
        self._pending.setdefault(step, {})
        if all(v <= 0 for v in self._expected[step].values()):
            # nothing routed to this bucket: assemble the empty step now
            # instead of wedging clients that wait on it forever
            self._assemble(step)
        return True

    def ingest(self, step: int, per_source: dict, n_bins: int) -> bool:
        """Batched ``expect`` + ``deposit`` in one RPC: ``per_source``
        maps source -> (samples, bins).  The planner's dispatch stage
        used to pay 1 + n_sources mailbox round-trips per constructor
        per step; this collapses them into one.  Returns False when the
        step is already assembled here (replan after recovery — first
        plan wins, exactly like ``expect``)."""
        counts = {src: len(samples)
                  for src, (samples, _bins) in per_source.items()}
        if not self.expect(step, counts or {"_": 0}, n_bins):
            return False
        for src, (samples, bins) in per_source.items():
            self.deposit(step, src, samples, bins)
        return True

    def deposit(self, step: int, source: str, samples: list[Sample],
                bins: list[int]):
        self.telemetry.inc("constructor_deposits_total", len(samples),
                           bucket=self.bucket, source=source)
        pend = self._pending.setdefault(step, {})
        for s, b in zip(samples, bins):
            pend.setdefault(b, []).append(s)
        exp = self._expected.get(step)
        if exp is not None:
            exp[source] = exp.get(source, 0) - len(samples)
            if all(v <= 0 for v in exp.values()):
                self._assemble(step)

    def _assemble(self, step: int):
        tel = self.telemetry
        with tel.span("constructor.assemble", bucket=self.bucket,
                      step=step):
            pend = self._pending.pop(step, {})
            self._expected.pop(step, None)
            bins = []
            for b in range(self.n_bins):
                samples = pend.get(b, [])
                batch = packing.pack_sequences(samples, self.seq_len,
                                               self.rows)
                packed_ids = {i for row in batch.doc_ids for i in row}
                for s in samples:
                    if s.sample_id not in packed_ids:
                        self._dropped += 1
                        tel.inc("constructor_dropped_total", 1.0,
                                bucket=self.bucket,
                                reason="packing_overflow")
                        if self.ledger is not None:
                            self.ledger.record_dropped(
                                step, s.sample_id, "packing_overflow")
                if tel.enabled:
                    tel.observe("constructor_bin_tokens",
                                int((batch.segment_ids > 0).sum()),
                                bucket=self.bucket)
                bins.append(batch)
            self._ready[step] = {"bins": bins}
            self._built_steps += 1
            # bound memory: drop oldest ready steps beyond queue depth
            while len(self._ready) > self.queue_depth:
                oldest = min(self._ready)
                if oldest == step:
                    break
                if self.ledger is not None:
                    for batch in self._ready[oldest]["bins"]:
                        for row in batch.doc_ids:
                            for sid in row:
                                self.ledger.record_dropped(
                                    oldest, sid, "queue_evicted")
                                tel.inc("constructor_dropped_total", 1.0,
                                        bucket=self.bucket,
                                        reason="queue_evicted")
                del self._ready[oldest]
        if tel.enabled:
            tel.set_gauge("constructor_ready_depth",
                          float(len(self._ready)), bucket=self.bucket)

    def ready_steps(self) -> list[int]:
        return sorted(self._ready)

    # -- client-facing fetch -------------------------------------------------
    def get_view(self, step: int, rank: int,
                 distribute_axis: str = "DP") -> Optional[dict]:
        """The parallelism transformation for one client."""
        if step not in self._ready:
            return None
        view = self.tree.client_view(rank, distribute_axis)
        bins = self._ready[step]["bins"]
        if view.role == "none":
            return {"role": "none", "step": step}
        if view.role == "metadata":
            return {"role": "metadata", "step": step,
                    "bins": [packing.metadata_only(b) for b in bins]}
        out_bins = []
        for b in bins:
            sliced = packing.cp_slice(b, view.cp_rank, view.cp_degree) \
                if view.cp_degree > 1 else b
            out_bins.append(sliced)
        return {"role": "data", "step": step, "bins": out_bins,
                "cp_rank": view.cp_rank}

    def pop_step(self, step: int):
        self._ready.pop(step, None)

    # -- introspection -----------------------------------------------------
    def stats(self) -> dict:
        return {"bucket": self.bucket, "ready": sorted(self._ready),
                "dropped": self._dropped, "built_steps": self._built_steps}

    def memory_bytes(self) -> int:
        total = 0
        for entry in self._ready.values():
            for b in entry["bins"]:
                total += b.tokens.nbytes + b.segment_ids.nbytes \
                    + b.positions.nbytes + b.labels.nbytes
        for pend in self._pending.values():
            for samples in pend.values():
                total += sum(s.tokens.nbytes + 200 for s in samples)
        return total

    def checkpoint_state(self) -> dict:
        # ``ready`` carries the in-flight window: steps assembled but not
        # yet consumed when the cut was taken.  A resumed job serves the
        # gap between the delivery frontier and the plan frontier from
        # these views — their samples were already popped from the loader
        # buffers, so they cannot be replanned, only restored.
        return {"bucket": self.bucket, "built_steps": self._built_steps,
                "dropped": self._dropped,
                "ready": {s: {"bins": list(e["bins"])}
                          for s, e in self._ready.items()}}

    def restore_state(self, state: dict):
        if state.get("bucket", self.bucket) != self.bucket:
            raise ValueError(
                f"checkpoint for bucket {state.get('bucket')} offered to "
                f"constructor bucket {self.bucket}")
        self._built_steps = state["built_steps"]
        self._dropped = state["dropped"]
        self._ready.update({int(s): {"bins": list(e["bins"])}
                            for s, e in state.get("ready", {}).items()})
