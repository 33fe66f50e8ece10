"""Microbatch transformations: packing, padding, positions, CP slicing.

Packing merges variable-length (sub)sequences into fixed ``seq_len`` rows
with segment ids (0 = padding) and within-segment positions — exactly the
representation models/attention.py masks on, so balanced packing converts
directly into balanced attention FLOPs.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, Optional, Sequence

import numpy as np


@dataclasses.dataclass
class PackedBatch:
    tokens: np.ndarray        # (rows, seq_len) int32
    segment_ids: np.ndarray   # (rows, seq_len) int32, 0 = pad
    positions: np.ndarray     # (rows, seq_len) int32
    labels: np.ndarray        # (rows, seq_len) int32, -1 = masked
    doc_ids: list             # per row: list of sample_ids packed into it

    @property
    def rows(self) -> int:
        return self.tokens.shape[0]

    def segment_lengths(self) -> list[list[int]]:
        out = []
        for r in range(self.rows):
            seg = self.segment_ids[r]
            lens = []
            for s in range(1, seg.max() + 1) if seg.max() > 0 else []:
                lens.append(int((seg == s).sum()))
            out.append(lens)
        return out


def pack_sequences(samples: Sequence, seq_len: int, rows: int,
                   pad_id: int = 0) -> PackedBatch:
    """First-fit packing of ``samples`` (each with .tokens) into a fixed
    (rows, seq_len) buffer.  Oversized samples are truncated to seq_len.
    Samples that don't fit are dropped (the planner sizes the selection so
    this doesn't happen in practice; tests assert on it)."""
    tokens = np.full((rows, seq_len), pad_id, np.int32)
    seg = np.zeros((rows, seq_len), np.int32)
    pos = np.zeros((rows, seq_len), np.int32)
    labels = np.full((rows, seq_len), -1, np.int32)
    fill = [0] * rows
    nseg = [0] * rows
    doc_ids: list[list[str]] = [[] for _ in range(rows)]
    for sm in samples:
        toks = np.asarray(sm.tokens, np.int32)[:seq_len]
        n = len(toks)
        if n == 0:
            continue
        # first row with room
        row = next((r for r in range(rows) if fill[r] + n <= seq_len), None)
        if row is None:
            continue
        a = fill[row]
        tokens[row, a:a + n] = toks
        nseg[row] += 1
        seg[row, a:a + n] = nseg[row]
        pos[row, a:a + n] = np.arange(n)
        labels[row, a:a + n - 1] = toks[1:]   # next-token targets
        fill[row] += n
        doc_ids[row].append(sm.sample_id)
    return PackedBatch(tokens, seg, pos, labels, doc_ids)


def pad_batch(batch: PackedBatch, rows: int) -> PackedBatch:
    """Pad/truncate to a fixed number of rows (constructor contract)."""
    cur = batch.rows
    if cur == rows:
        return batch
    if cur > rows:
        return PackedBatch(batch.tokens[:rows], batch.segment_ids[:rows],
                           batch.positions[:rows], batch.labels[:rows],
                           batch.doc_ids[:rows])
    def pad(a, fillv):
        extra = np.full((rows - cur,) + a.shape[1:], fillv, a.dtype)
        return np.concatenate([a, extra], 0)
    return PackedBatch(pad(batch.tokens, 0), pad(batch.segment_ids, 0),
                       pad(batch.positions, 0), pad(batch.labels, -1),
                       batch.doc_ids + [[] for _ in range(rows - cur)])


def cp_slice(batch: PackedBatch, cp_rank: int, cp_degree: int,
             zigzag: bool = True) -> PackedBatch:
    """Context-parallel sequence partition.  Zig-zag interleaving (pair
    chunk i with chunk 2*cp-1-i) balances causal-attention work per rank."""
    s = batch.tokens.shape[1]
    assert s % (2 * cp_degree) == 0 or not zigzag, (s, cp_degree)
    if cp_degree == 1:
        return batch
    if zigzag:
        chunk = s // (2 * cp_degree)
        idx = np.concatenate([
            np.arange(cp_rank * chunk, (cp_rank + 1) * chunk),
            np.arange((2 * cp_degree - 1 - cp_rank) * chunk,
                      (2 * cp_degree - cp_rank) * chunk)])
    else:
        chunk = s // cp_degree
        idx = np.arange(cp_rank * chunk, (cp_rank + 1) * chunk)
    return PackedBatch(batch.tokens[:, idx], batch.segment_ids[:, idx],
                       batch.positions[:, idx], batch.labels[:, idx],
                       batch.doc_ids)


def metadata_only(batch: PackedBatch) -> dict:
    """What pp>0 stages receive: shapes + segment structure, no payloads."""
    return {
        "rows": batch.rows,
        "seq_len": int(batch.tokens.shape[1]),
        "segment_counts": [int(batch.segment_ids[r].max())
                           for r in range(batch.rows)],
        "token_counts": [int((batch.segment_ids[r] > 0).sum())
                         for r in range(batch.rows)],
    }
