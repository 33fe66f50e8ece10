"""Colocated dataloader baseline (paper §2.2 / §7.2 comparison arm).

Mirrors Megatron/DDP-style per-rank loaders: EVERY data-parallel rank runs
its own loader process group that (a) opens ALL sources (replicated file
access states) and (b) runs ``workers`` worker processes each holding an
independent prefetch buffer — the two memory-scaling dimensions OVERLORD
removes.  No cross-rank planning: each rank samples its own mixture slice,
so packed-batch imbalance is whatever the draw gives (the Vanilla arm).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.core.mixing import MixSchedule, sample_counts
from repro_torch.data import packing
from repro_torch.data.storage import SourceReader
from repro_torch.data.transforms import transform_record


@dataclasses.dataclass
class ColocatedRankLoader:
    rank: int
    readers: dict                 # source -> SourceReader (ALL sources)
    workers: int
    seq_len: int
    rows: int
    buffer_per_worker: int = 64

    def memory_bytes(self) -> int:
        access = sum(r.access_state_bytes for r in self.readers.values())
        # each worker: its own execution context + prefetch buffer of
        # transformed samples (~seq_len tokens each)
        worker = self.workers * (64 * 1024
                                 + self.buffer_per_worker
                                 * (self.seq_len * 4 + 200))
        return access + worker


class ColocatedFleet:
    """One loader per DP rank, each opening every source."""

    def __init__(self, source_paths: dict[str, str], dp_ranks: int,
                 workers: int, seq_len: int, rows: int,
                 schedule: MixSchedule, vocab_size: int = 50_000,
                 seed: int = 0):
        self.schedule = schedule
        self.vocab_size = vocab_size
        self.seq_len = seq_len
        self.rows = rows
        self.rngs = [np.random.default_rng(seed + r)
                     for r in range(dp_ranks)]
        self.loaders = []
        for r in range(dp_ranks):
            readers = {n: SourceReader(p) for n, p in source_paths.items()}
            self.loaders.append(ColocatedRankLoader(
                r, readers, workers, seq_len, rows))

    def memory_bytes(self) -> int:
        return sum(l.memory_bytes() for l in self.loaders)

    def rank_batch(self, rank: int, step: int,
                   samples_per_rank: int) -> packing.PackedBatch:
        """Independent per-rank sampling (no global orchestration)."""
        l = self.loaders[rank]
        counts = sample_counts(self.schedule.weights(step),
                               samples_per_rank, self.rngs[rank])
        samples = []
        for src, k in counts.items():
            if src not in l.readers or k == 0:
                continue
            for rec in l.readers[src].read(k):
                samples.append(transform_record(rec, src, self.vocab_size))
        return packing.pack_sequences(samples, self.seq_len, self.rows)

    def close(self):
        for l in self.loaders:
            for r in l.readers.values():
                r.close()
