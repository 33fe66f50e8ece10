"""Columnar row-group storage (Parquet-like) with MEASURED access states.

The paper's multisource memory argument (§2.3) rests on per-open-file state:
socket, footer/schema metadata, row-group index, read buffer.  We reproduce
that faithfully: every ``SourceReader`` holds real bytes for each of those
and reports them, so the memory benchmarks (Figs. 4/5/14/15) measure actual
resident state rather than assumed constants.

File layout:  [row_group_0][row_group_1]...[footer][footer_len(8B)][MAGIC]
Row groups are pickled column dicts; the footer carries schema, per-group
(offset, nbytes, nrows) and per-group column statistics.
"""
from __future__ import annotations

import dataclasses
import io
import json
import os
import pickle
import struct
import threading
from typing import Any, Iterator, Optional

MAGIC = b"OVLDCOL1"
DEFAULT_ROW_GROUP_ROWS = 256

# global registry of open readers -> fleet-wide access-state accounting
_OPEN_READERS: dict[int, "SourceReader"] = {}
_REG_LOCK = threading.Lock()

# storage-layer fault hook (repro.chaos): called at the top of every
# SourceReader.read with (reader, n); it may raise TransientIOError to
# model a storage hiccup.  One global slot — installers must restore the
# previous hook on teardown (FaultInjector does).
_FAULT_HOOK = None


def set_fault_hook(hook):
    """Install a read-fault hook; returns the previously installed one."""
    global _FAULT_HOOK
    prev, _FAULT_HOOK = _FAULT_HOOK, hook
    return prev


def clear_fault_hook():
    set_fault_hook(None)


def open_access_state_bytes() -> int:
    with _REG_LOCK:
        return sum(r.access_state_bytes for r in _OPEN_READERS.values())


def open_reader_count() -> int:
    with _REG_LOCK:
        return len(_OPEN_READERS)


def write_source(path: str, records: list[dict],
                 row_group_rows: int = DEFAULT_ROW_GROUP_ROWS) -> dict:
    """Write records (list of column dicts) as a columnar file."""
    assert records, "empty source"
    columns = sorted(records[0].keys())
    groups = []
    buf = io.BytesIO()
    for start in range(0, len(records), row_group_rows):
        chunk = records[start:start + row_group_rows]
        coldata = {c: [r[c] for r in chunk] for c in columns}
        blob = pickle.dumps(coldata, protocol=pickle.HIGHEST_PROTOCOL)
        groups.append({
            "offset": buf.tell(),
            "nbytes": len(blob),
            "nrows": len(chunk),
            "stats": {c: _col_stats(coldata[c]) for c in columns},
        })
        buf.write(blob)
    footer = {
        "schema": {c: type(records[0][c]).__name__ for c in columns},
        "columns": columns,
        "num_rows": len(records),
        "row_groups": groups,
    }
    fbytes = json.dumps(footer).encode()
    with open(path, "wb") as f:
        f.write(buf.getvalue())
        f.write(fbytes)
        f.write(struct.pack("<Q", len(fbytes)))
        f.write(MAGIC)
    return footer


def _col_stats(vals) -> dict:
    if vals and isinstance(vals[0], (int, float)):
        return {"min": min(vals), "max": max(vals),
                "sum": float(sum(vals))}
    return {"len": len(vals)}


@dataclasses.dataclass
class AccessState:
    footer_bytes: int = 0
    schema_bytes: int = 0
    index_bytes: int = 0
    buffer_bytes: int = 0
    socket_bytes: int = 8192     # connection buffers (S3/HDFS client stand-in)

    @property
    def total(self) -> int:
        return (self.footer_bytes + self.schema_bytes + self.index_bytes
                + self.buffer_bytes + self.socket_bytes)


class SourceReader:
    """One open source file == one set of access states (the unit the
    paper's Source Parallelism partitions)."""

    def __init__(self, path: str, shard: tuple[int, int] = (0, 1)):
        self.path = path
        self.shard_index, self.shard_count = shard
        self._f = open(path, "rb")
        self._f.seek(-8 - len(MAGIC), os.SEEK_END)
        flen = struct.unpack("<Q", self._f.read(8))[0]
        assert self._f.read(len(MAGIC)) == MAGIC, f"bad magic in {path}"
        self._f.seek(-8 - len(MAGIC) - flen, os.SEEK_END)
        self._footer_raw = self._f.read(flen)
        self.footer = json.loads(self._footer_raw)
        self._groups = self.footer["row_groups"]
        self._buffer: Optional[bytes] = None
        self._buffer_group: int = -1
        self._cursor = 0  # row index within this shard's row space
        # source-parallel partitioning (§5.1): a sharded reader keeps only
        # ITS row groups' index entries + proportional read-ahead buffers
        my_groups = [self._groups[g] for g in self._my_groups()]
        self.state = AccessState(
            footer_bytes=len(self._footer_raw) // self.shard_count,
            schema_bytes=len(json.dumps(self.footer["schema"]).encode()),
            index_bytes=len(json.dumps(my_groups).encode()),
        )
        with _REG_LOCK:
            _OPEN_READERS[id(self)] = self

    # shard-aware row space: reader (i, n) owns row groups g with g%n == i
    def _my_groups(self) -> list[int]:
        return [g for g in range(len(self._groups))
                if g % self.shard_count == self.shard_index]

    @property
    def num_rows(self) -> int:
        return sum(self._groups[g]["nrows"] for g in self._my_groups())

    @property
    def access_state_bytes(self) -> int:
        self.state.buffer_bytes = len(self._buffer) if self._buffer else 0
        return self.state.total

    def _load_group(self, gidx: int) -> dict:
        if gidx != self._buffer_group:
            g = self._groups[gidx]
            self._f.seek(g["offset"])
            self._buffer = self._f.read(g["nbytes"])
            self._buffer_group = gidx
        return pickle.loads(self._buffer)

    def read(self, n: int) -> list[dict]:
        """Read the next n records (wrapping around: epoch semantics)."""
        hook = _FAULT_HOOK
        if hook is not None:
            hook(self, n)   # may raise TransientIOError
        mine = self._my_groups()
        if not mine:
            return []
        total = self.num_rows
        out = []
        while len(out) < n:
            row = self._cursor % total
            # locate group
            acc = 0
            for g in mine:
                nr = self._groups[g]["nrows"]
                if row < acc + nr:
                    cols = self._load_group(g)
                    local = row - acc
                    rec = {c: v[local] for c, v in cols.items()}
                    rec["_row_id"] = f"{os.path.basename(self.path)}" \
                        f":{g}:{local}"
                    out.append(rec)
                    break
                acc += nr
            self._cursor += 1
        return out

    def seek(self, cursor: int):
        self._cursor = cursor

    def tell(self) -> int:
        return self._cursor

    def close(self):
        with _REG_LOCK:
            _OPEN_READERS.pop(id(self), None)
        self._f.close()
        self._buffer = None

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()
