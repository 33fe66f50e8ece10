"""SourceLoader actor: per-source ingest + sample transformations (§3).

One actor per (source, data-parallel shard).  Holds exactly ONE set of
file access states (the point of source disaggregation: memory scales with
sources, not sources x ranks x workers).  ``workers`` models worker-
parallel transform slots: transforms of a refill batch are amortized
across workers (P/n), which the AutoScaler provisions (§5).

State = (file cursor, rng counter, buffer contents) — checkpointable, and
replayable from plan history (fault.py's differential checkpointing).

Hardened paths (docs/FAULT_TOLERANCE.md): storage reads go through a
RetryPolicy and a per-source CircuitBreaker (open after N consecutive
failures, half-open probe after a cooldown; while open, the loader serves
from its buffer and the Planner re-mixes across healthy sources), and
corrupted records are quarantined into a DeadLetterQueue with source
attribution instead of killing the actor.  ``inject_fault`` is the
deterministic entry point the chaos harness drives.
"""
from __future__ import annotations

import sys
import time
from typing import Any, Optional

import numpy as np

from repro_torch.core.actors import Actor
from repro_torch.core.resilience import (
    CircuitBreaker, CorruptSampleError, DeadLetterQueue, RetryPolicy,
    TransientIOError,
)
from repro_torch.data.storage import SourceReader
from repro_torch.data.transforms import (
    Sample, record_metadata, transform_record, validate_record,
)
from repro_torch.telemetry import Telemetry, ensure_telemetry


class SourceLoader(Actor):
    def __init__(self, source: str, path: str,
                 shard: tuple[int, int] = (0, 1), workers: int = 1,
                 buffer_target: int = 256, vocab_size: int = 50_000,
                 work_scale: float = 0.0, seed: int = 0,
                 retry: Optional[RetryPolicy] = None,
                 breaker: Optional[CircuitBreaker] = None,
                 dlq: Optional[DeadLetterQueue] = None,
                 telemetry: Optional[Telemetry] = None):
        self.source = source
        self.path = path
        self.shard = shard
        self.workers = max(int(workers), 1)
        self.buffer_target = buffer_target
        self.vocab_size = vocab_size
        self.work_scale = work_scale
        self.seed = seed
        self.retry = retry or RetryPolicy(max_attempts=3,
                                          base_delay_s=0.01,
                                          max_delay_s=0.2, seed=seed)
        self.breaker = breaker if breaker is not None else CircuitBreaker()
        # NOT `dlq or ...`: an empty DeadLetterQueue is falsy (len 0) and
        # `or` would silently replace the shared queue with a private one
        self.dlq = dlq if dlq is not None else DeadLetterQueue()
        self.telemetry = ensure_telemetry(telemetry)
        self._reader: Optional[SourceReader] = None
        self._buffer: list[dict] = []      # raw records awaiting dispatch
        self._virtual_time = 0.0           # accumulated transform cost units
        self._samples_loaded = 0
        self._fail_next = False
        self._read_failures = 0
        self._quarantined = 0
        # chaos state (inject_fault): remaining io-error reads, slow-call
        # budget, pending hang seconds
        self._chaos: dict[str, Any] = {"io_error": 0, "slow_calls": 0,
                                       "slow_delay": 0.0, "corrupt_next": 0}

    # -- lifecycle --------------------------------------------------------
    def on_start(self):
        self._reader = SourceReader(self.path, self.shard)
        self.refill()

    def on_stop(self):
        if self._reader is not None:
            self._reader.close()

    # -- buffer management --------------------------------------------------
    def _read(self, need: int) -> list[dict]:
        if self._chaos["io_error"] > 0:
            self._chaos["io_error"] -= 1
            raise TransientIOError(
                f"injected io error on {self.source}")
        return self._reader.read(need)

    def refill(self, target: Optional[int] = None):
        """Read from storage until the buffer reaches its target depth.

        Reads are retried per RetryPolicy; persistent failure trips the
        circuit breaker and the loader keeps serving from its buffer."""
        target = target or self.buffer_target
        need = target - len(self._buffer)
        if need <= 0:
            return len(self._buffer)
        tel = self.telemetry
        with tel.span("loader.refill", source=self.source,
                      need=need) as sp:
            if not self.breaker.allow():
                sp.set_attr("skipped", "breaker_open")
                self._sample_gauges()
                return len(self._buffer)   # open: degrade, don't block
            try:
                records = self.retry.run(
                    self._read, need, on_retry=self._on_read_retry)
            except Exception:
                self._read_failures += 1
                self.breaker.record_failure()
                tel.inc("loader_read_failures_total", 1.0,
                        source=self.source)
                sp.set_attr("failed", True)
                self._sample_gauges()
                return len(self._buffer)
            self.breaker.record_success()
            self._buffer.extend(records)
            self._samples_loaded += len(records)
            tel.inc("loader_records_read_total", len(records),
                    source=self.source)
        self._sample_gauges()
        return len(self._buffer)

    def _on_read_retry(self, attempt: int, exc: BaseException):
        self.telemetry.inc("loader_read_retries_total", 1.0,
                           source=self.source)

    def _sample_gauges(self):
        tel = self.telemetry
        if not tel.enabled:
            return
        tel.set_gauge("loader_buffer_depth", float(len(self._buffer)),
                      source=self.source, actor=self.name)
        tel.set_gauge("breaker_state", self.breaker.gauge_value(),
                      source=self.source)

    def summary_buffer(self) -> list[dict]:
        """Metadata the Planner plans over (never payloads)."""
        return [record_metadata(r, self.source) for r in self._buffer]

    def snapshot(self) -> dict:
        """Buffer metadata + health in ONE round-trip.  The Planner's
        collect stage used to pay two blocking RPCs per loader
        (``summary_buffer`` then ``health``); planning latency is on the
        step critical path, so the pair is collapsed into one mailbox
        message per loader per step."""
        return {"entries": self.summary_buffer(), "health": self.health()}

    # -- plan execution -------------------------------------------------------
    def prepare(self, sample_ids: list[str]) -> list[Sample]:
        """Pop the planned records from the buffer, run sample transforms
        (amortized across worker-parallel slots), return Samples.
        Corrupted records are quarantined into the DLQ, not raised."""
        tel = self.telemetry
        with tel.span("loader.prepare", source=self.source,
                      n=len(sample_ids)):
            self._chaos_latency()
            if self._fail_next:
                self._fail_next = False
                raise RuntimeError(
                    f"injected failure in loader {self.name}")
            wanted = set(sample_ids)
            picked, rest = [], []
            for r in self._buffer:
                (picked if r["sample_id"] in wanted else rest).append(r)
            self._buffer = rest
            out = []
            cost = 0.0
            for r in picked:
                if self._chaos["corrupt_next"] > 0:
                    self._chaos["corrupt_next"] -= 1
                    r = dict(r)
                    r["_corrupt"] = "chaos"
                try:
                    validate_record(r)
                except CorruptSampleError as e:
                    self._quarantined += 1
                    self.dlq.put(str(r.get("sample_id", "?")), self.source,
                                 str(e))
                    tel.inc("loader_quarantined_total", 1.0,
                            source=self.source)
                    continue
                s = transform_record(r, self.source, self.vocab_size,
                                     self.work_scale)
                cost += s.virtual_cost
                out.append(s)
            # worker parallelism amortizes transform latency (§5.1: P/n)
            self._virtual_time += cost / self.workers
            if out:
                tel.inc("loader_samples_prepared_total", len(out),
                        source=self.source)
                tel.observe("loader_prepare_cost", cost,
                            source=self.source)
            self.refill()
            return out

    # -- fault injection / introspection ---------------------------------------
    def inject_failure(self):
        self._fail_next = True

    def inject_fault(self, kind: str, **params) -> dict:
        """Deterministic fault hooks the chaos harness drives via cast():

          * hang     — sleep ``seconds`` on the mailbox thread NOW
          * slow     — delay the next ``calls`` prepare() calls by ``delay``
          * io_error — fail the next ``reads`` storage reads (feeds the
                       retry policy and circuit breaker)
          * corrupt  — poison the next ``samples`` records prepare() pops
                       (caught by validate_record -> DLQ)
          * crash    — raise on the next prepare() (legacy inject_failure)
        """
        if kind == "hang":
            time.sleep(float(params.get("seconds", 0.2)))
        elif kind == "slow":
            self._chaos["slow_calls"] = int(params.get("calls", 3))
            self._chaos["slow_delay"] = float(params.get("delay", 0.02))
        elif kind == "io_error":
            self._chaos["io_error"] += int(params.get("reads", 3))
        elif kind == "corrupt":
            self._chaos["corrupt_next"] += int(params.get("samples", 3))
        elif kind == "crash":
            self._fail_next = True
        else:
            raise ValueError(f"unknown fault kind {kind!r}")
        return {"kind": kind, "params": dict(params), "source": self.source}

    def _chaos_latency(self):
        if self._chaos["slow_calls"] > 0:
            self._chaos["slow_calls"] -= 1
            time.sleep(self._chaos["slow_delay"])

    def health(self) -> dict:
        """Degradation signal the Planner re-mixes on (breaker state)."""
        return {
            "source": self.source,
            "breaker": self.breaker.state,
            "read_failures": self._read_failures,
            "quarantined": self._quarantined,
            "buffer_depth": len(self._buffer),
        }

    def stats(self) -> dict:
        return {
            "source": self.source,
            "shard": self.shard,
            "workers": self.workers,
            "buffer_depth": len(self._buffer),
            "virtual_time": self._virtual_time,
            "samples_loaded": self._samples_loaded,
            "read_failures": self._read_failures,
            "quarantined": self._quarantined,
            "breaker": self.breaker.stats(),
            "cursor": self._reader.tell() if self._reader else 0,
            "access_state_bytes":
                self._reader.access_state_bytes if self._reader else 0,
        }

    def memory_bytes(self) -> int:
        access = self._reader.access_state_bytes if self._reader else 0
        buf = sum(len(r.get("payload", b"")) + 200 for r in self._buffer)
        # each worker slot holds an execution context + prefetch slot
        worker_overhead = self.workers * 64 * 1024
        return access + buf + worker_overhead

    # -- checkpointing -----------------------------------------------------------
    def checkpoint_state(self) -> dict:
        # NOTE: includes the buffer payloads — this is exactly why the
        # paper gives loaders a LOWER checkpoint frequency than the planner
        # and covers the gap with plan replay (differential checkpointing).
        return {
            "source": self.source, "shard": self.shard,
            "cursor": self._reader.tell(),
            "buffer": [dict(r) for r in self._buffer],
            "samples_loaded": self._samples_loaded,
            "virtual_time": self._virtual_time,
        }

    def restore_state(self, state: dict):
        # identity guard: a manifest built for another (source, shard)
        # must not silently seed this loader's cursor (fenced resume maps
        # states by actor name; a mismatch means the mapping is wrong)
        if state.get("source", self.source) != self.source \
                or tuple(state.get("shard", self.shard)) != \
                tuple(self.shard):
            raise ValueError(
                f"checkpoint for {state.get('source')}:{state.get('shard')}"
                f" offered to loader {self.source}:{self.shard}")
        self._buffer = [dict(r) for r in state["buffer"]]
        self._reader.seek(state["cursor"])
        self._samples_loaded = state["samples_loaded"]
        self._virtual_time = state["virtual_time"]

    def replay(self, sample_id_lists: list[list[str]]):
        """Replay planned pops since the restored checkpoint (storage reads
        are deterministic given the cursor, so state converges)."""
        for ids in sample_id_lists:
            self.prepare(ids)
