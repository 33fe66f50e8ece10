"""Non-interrupted fault tolerance (§6.1, Fig. 11/16) + durable job
recovery (§6.1 deployment story: restart the dataloader JOB without
re-reading delivered samples).

  * CheckpointStore — persistent store with per-actor DIFFERENTIAL
    frequencies: the Planner journals every step (small state), Source
    Loaders every ``loader_every`` steps (large buffers), and the gap is
    covered by replaying the Planner's plan history against the restored
    loader ("replay window").

    On disk the store is CRASH-CONSISTENT: every blob is framed with a
    magic/version/CRC32 header (a truncated or bit-rotted ``.ckpt`` is
    rejected, never unpickled), and a run's state is only visible to a
    resuming job once an epoch MANIFEST — written atomically via
    tmp+rename — references the blobs.  Manifests carry a monotonic job
    epoch; ``latest_manifest()`` walks epochs newest-first and falls back
    past any inconsistent epoch.  Old epochs and unreferenced blobs are
    garbage-collected (``keep_epochs`` retained).

    Writes are FENCED: each (re)starting job acquires a monotonic token
    from the ``FENCE`` file; a zombie pre-crash incarnation still holding
    an older token can never commit a manifest over the new job's state
    (its commits are refused and counted in ``stats()``).

  * ShadowManager — hot-standby shadow loaders kept in sync by periodic
    state mirroring; on failure the supervisor promotes the shadow
    immediately (no storage round-trip), so data delivery never pauses.

Failures on either path are COUNTED and surfaced through ``stats()``
(save/load failures per actor, fenced writes, manifest fallbacks,
shadow-sync staleness in steps) — a save or sync that silently fails is
how recovery quietly rots, so the chaos harness asserts on these
counters.  Layout and fencing semantics: docs/FAULT_TOLERANCE.md.
"""
from __future__ import annotations

import collections
import json
import os
import pickle
import re
import struct
import threading
import time
import zlib
from typing import Callable, Optional

from repro_torch.core.actors import Actor, ActorHandle, ActorRuntime
from repro_torch.core.source_loader import SourceLoader

#: manifest document schema version (bump on incompatible layout change)
MANIFEST_VERSION = 1

# blob framing: magic | version | crc32(payload) | len(payload) | payload
_BLOB_MAGIC = b"MSDC"
_BLOB_VERSION = 1
_HEADER = struct.Struct("<4sBIQ")
_MANIFEST_RE = re.compile(r"^epoch-(\d{8})\.manifest\.json$")
_BLOB_STEP_RE = re.compile(r"@(\d+)\.t\d+\.ckpt$")

#: manifest key for the persisted DeliveryLedger snapshot
LEDGER_KEY = "__ledger__"


class CheckpointCorruption(ValueError):
    """A checkpoint blob failed framing / checksum verification."""


def frame_blob(payload: bytes) -> bytes:
    """Self-verifying on-disk framing for checkpoint payloads."""
    return _HEADER.pack(_BLOB_MAGIC, _BLOB_VERSION,
                        zlib.crc32(payload), len(payload)) + payload


def unframe_blob(data: bytes) -> bytes:
    """Inverse of ``frame_blob``; raises CheckpointCorruption on a
    truncated, foreign, or bit-rotted blob instead of unpickling it."""
    if len(data) < _HEADER.size:
        raise CheckpointCorruption(
            f"truncated blob header ({len(data)} bytes)")
    magic, version, crc, length = _HEADER.unpack_from(data)
    if magic != _BLOB_MAGIC:
        raise CheckpointCorruption(f"bad blob magic {magic!r}")
    if version != _BLOB_VERSION:
        raise CheckpointCorruption(f"unknown blob version {version}")
    payload = data[_HEADER.size:]
    if len(payload) != length:
        raise CheckpointCorruption(
            f"truncated blob payload ({len(payload)} of {length} bytes)")
    if zlib.crc32(payload) != crc:
        raise CheckpointCorruption("blob checksum mismatch (bit rot?)")
    return payload


class CheckpointStore:
    def __init__(self, root: Optional[str] = None,
                 planner_every: int = 1, loader_every: int = 8,
                 restore_delay_s: float = 0.0, keep_epochs: int = 3):
        self.root = root
        self.planner_every = planner_every
        self.loader_every = loader_every
        self.keep_epochs = max(int(keep_epochs), 1)
        # models remote persistent-store read latency (benchmarks inject a
        # realistic value; production would see storage RTT here)
        self.restore_delay_s = restore_delay_s
        self._mem: dict[str, tuple[int, bytes]] = {}
        self._lock = threading.Lock()
        self._saves: collections.Counter = collections.Counter()
        self._save_failures: collections.Counter = collections.Counter()
        self._load_failures: collections.Counter = collections.Counter()
        self._last_failure: dict[str, str] = {}
        # durable-manifest state (all guarded by _lock)
        self._blob_index: dict[str, dict] = {}   # name -> manifest entry
        self._cut_entries: dict[str, dict] = {}  # last consistent actor cut
        self._cut_frontier = -1                  # plan frontier of that cut
        self._fence_token: Optional[int] = None
        self._epoch = 0                          # last epoch committed
        self._fenced_writes = 0
        self._manifests_committed = 0
        self._manifest_fallbacks = 0
        self._manifest_cache: Optional[dict] = None
        if root:
            os.makedirs(root, exist_ok=True)

    # ------------------------------------------------------------ fencing
    def _fence_path(self) -> str:
        return os.path.join(self.root, "FENCE")

    def _read_fence(self) -> int:
        try:
            with open(self._fence_path(), encoding="utf-8") as f:
                return int(json.load(f)["token"])
        except (OSError, ValueError, KeyError):
            return 0

    def acquire_fence(self) -> int:
        """Claim the job fence: bump the on-disk token so any OLDER
        incarnation still running is fenced out of future commits.
        Idempotent per store instance (a store acquires at most once)."""
        if not self.root:
            with self._lock:
                if self._fence_token is None:
                    self._fence_token = 0
                return self._fence_token
        with self._lock:
            if self._fence_token is not None:
                return self._fence_token
            token = self._read_fence() + 1
            tmp = self._fence_path() + ".tmp"
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump({"token": token, "acquired_at": time.time()}, f)
            os.replace(tmp, self._fence_path())
            self._fence_token = token
            self._epoch = max((e for e, _ in self._manifest_files()),
                              default=0)
            return token

    @property
    def fence_token(self) -> Optional[int]:
        return self._fence_token

    def is_fenced(self) -> bool:
        """True when a NEWER incarnation holds the fence: this store must
        no longer commit (zombie protection for the resumed job)."""
        if not self.root or self._fence_token is None:
            return False
        return self._read_fence() > self._fence_token

    # ---------------------------------------------------------- blob I/O
    def _blobs_dir(self) -> str:
        return os.path.join(self.root, "blobs")

    def _blob_name(self, name: str, step: int) -> str:
        safe = name.replace(os.sep, "_")
        token = self._fence_token or 0
        return f"{safe}@{step}.t{token}.ckpt"

    def _write_blob(self, name: str, step: int, payload: bytes,
                    label_step: Optional[int] = None) -> dict:
        """Write one framed blob atomically; returns its manifest entry.
        Blob filenames embed the fence token, so a zombie incarnation's
        writes can never clobber a blob the new job's manifest names.
        ``label_step`` decouples the entry's semantic step (replay-window
        sizing) from the filename step (uniqueness across commits)."""
        rel = os.path.join("blobs", self._blob_name(name, step))
        path = os.path.join(self.root, rel)
        os.makedirs(self._blobs_dir(), exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(frame_blob(payload))
        os.replace(tmp, path)
        entry = {"step": int(step if label_step is None else label_step),
                 "blob": rel,
                 "crc32": zlib.crc32(payload), "size": len(payload)}
        with self._lock:
            self._blob_index[name] = entry
        return entry

    def _read_entry_payload(self, entry: dict) -> bytes:
        path = os.path.join(self.root, entry["blob"])
        with open(path, "rb") as f:
            payload = unframe_blob(f.read())
        if zlib.crc32(payload) != entry.get("crc32") \
                or len(payload) != entry.get("size"):
            raise CheckpointCorruption(
                f"{entry['blob']}: blob does not match its manifest entry")
        return payload

    def _count_load_failure(self, name: str, exc: BaseException) -> None:
        with self._lock:
            self._load_failures[name] += 1
            self._last_failure[name] = f"{type(exc).__name__}: {exc}"

    def _decode(self, name: str, data: bytes) -> Optional[dict]:
        """Framed blob -> payload, else legacy raw pickle; corruption is
        counted as a load failure and yields None (caller falls back)."""
        try:
            if data[:len(_BLOB_MAGIC)] == _BLOB_MAGIC:
                return pickle.loads(unframe_blob(data))
            return pickle.loads(data)
        except Exception as e:   # truncated pickle, bad frame, bit rot
            self._count_load_failure(name, e)
            return None

    # ---------------------------------------------------------- manifests
    def _manifest_files(self) -> list[tuple[int, str]]:
        """(epoch, path) for every manifest on disk, ascending."""
        if not self.root or not os.path.isdir(self.root):
            return []
        out = []
        for fn in os.listdir(self.root):
            m = _MANIFEST_RE.match(fn)
            if m:
                out.append((int(m.group(1)), os.path.join(self.root, fn)))
        return sorted(out)

    def _verify_manifest(self, path: str) -> Optional[dict]:
        """Parse + verify one manifest: every referenced blob must exist
        and pass its checksum, or the whole epoch is inconsistent."""
        try:
            with open(path, encoding="utf-8") as f:
                doc = json.load(f)
        except (OSError, ValueError):
            return None
        if doc.get("version") != MANIFEST_VERSION \
                or not isinstance(doc.get("actors"), dict):
            return None
        entries = list(doc["actors"].values())
        if doc.get("ledger"):
            entries.append(doc["ledger"])
        for entry in entries:
            try:
                self._read_entry_payload(entry)
            except (CheckpointCorruption, OSError, KeyError, TypeError):
                return None
        return doc

    def latest_manifest(self) -> Optional[dict]:
        """Newest CONSISTENT manifest.  Inconsistent epochs (corrupt
        manifest JSON or any bad blob) are skipped — recovery falls back
        to the last good epoch instead of crashing — and counted."""
        with self._lock:
            if self._manifest_cache is not None:
                return self._manifest_cache
        for _epoch, path in reversed(self._manifest_files()):
            doc = self._verify_manifest(path)
            if doc is not None:
                with self._lock:
                    self._manifest_cache = doc
                return doc
            with self._lock:
                self._manifest_fallbacks += 1
                self._last_failure["__manifest__"] = \
                    f"CheckpointCorruption: inconsistent epoch at {path}"
        return None

    def _fence_ok(self) -> bool:
        if self._fence_token is None:
            self.acquire_fence()
        if self.is_fenced():
            with self._lock:
                self._fenced_writes += 1
                self._last_failure["__manifest__"] = (
                    "FencedWrite: a newer incarnation holds the fence "
                    f"(mine={self._fence_token}, disk={self._read_fence()})")
            return False
        return True

    def _write_ledger_blob(self, step: int,
                           ledger_state: Optional[object]) -> Optional[dict]:
        if ledger_state is None:
            return None
        try:
            return self._write_blob(LEDGER_KEY, step,
                                    pickle.dumps(ledger_state))
        except OSError as e:
            with self._lock:
                self._save_failures[LEDGER_KEY] += 1
                self._last_failure[LEDGER_KEY] = f"{type(e).__name__}: {e}"
            return None

    def _commit_epoch(self, step: int, actors: dict,
                      ledger_entry: Optional[dict],
                      frontier: int) -> Optional[int]:
        """The commit point: one atomic manifest rename.  A crash before
        it leaves the previous epoch authoritative; after it,
        ``latest_manifest`` returns this one."""
        with self._lock:
            epoch = self._epoch + 1
            token = self._fence_token
        doc = {"version": MANIFEST_VERSION, "epoch": epoch,
               "step": int(step), "frontier": int(frontier),
               "fence_token": token, "committed_at": time.time(),
               "actors": actors, "ledger": ledger_entry}
        path = os.path.join(self.root, f"epoch-{epoch:08d}.manifest.json")
        try:
            tmp = path + ".tmp"
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump(doc, f, indent=1, sort_keys=True)
            os.replace(tmp, path)
        except OSError as e:
            with self._lock:
                self._save_failures["__manifest__"] += 1
                self._last_failure["__manifest__"] = \
                    f"{type(e).__name__}: {e}"
            return None
        with self._lock:
            self._epoch = epoch
            self._manifests_committed += 1
            self._manifest_cache = doc
        self._gc()
        return epoch

    def commit_manifest(self, step: int,
                        ledger_state: Optional[object] = None
                        ) -> Optional[int]:
        """Commit the current ``maybe_save`` blob set as a new job epoch.
        ``ledger_state`` (a DeliveryLedger snapshot) is persisted
        alongside, so exactly-once accounting spans process restarts.
        Returns the epoch, or None when fenced / diskless.  NOTE: blobs
        saved from the Overlord thread race the plan-ahead pipeline; the
        Overlord commits planner-consistent ``commit_cut`` epochs
        instead, this variant serves direct store users and tests."""
        if not self.root or not self._fence_ok():
            return None
        ledger_entry = self._write_ledger_blob(step, ledger_state)
        with self._lock:
            actors = {n: dict(e) for n, e in self._blob_index.items()
                      if n != LEDGER_KEY}
        frontier = max([e["step"] for e in actors.values()], default=step)
        return self._commit_epoch(step, actors, ledger_entry, frontier)

    def commit_cut(self, step: int, cut: dict) -> Optional[int]:
        """Commit a ``Planner.capture_cut`` as a new job epoch.  Actors
        absent from this cut (differential frequency: loader/constructor
        blobs are captured less often than the planner's) keep their
        entries from the previous cut — inherited via ``adopt_cut`` on
        resume — so every manifest references a complete, mutually
        consistent blob set."""
        if not self.root or not self._fence_ok():
            return None
        frontier = int(cut.get("frontier", step))
        new_entries = {}
        try:
            new_entries["planner"] = self._write_blob(
                "planner", step,
                pickle.dumps({"step": frontier, "state": cut["planner"]}),
                label_step=frontier)
            for name, state in (cut.get("actors") or {}).items():
                new_entries[name] = self._write_blob(
                    name, step,
                    pickle.dumps({"step": frontier, "state": state}),
                    label_step=frontier)
        except OSError as e:
            with self._lock:
                self._save_failures["__manifest__"] += 1
                self._last_failure["__manifest__"] = \
                    f"{type(e).__name__}: {e}"
            return None
        with self._lock:
            if cut.get("actors"):
                self._cut_entries = {n: dict(e)
                                     for n, e in new_entries.items()
                                     if n != "planner"}
                self._cut_frontier = frontier
            actors = {n: dict(e) for n, e in self._cut_entries.items()}
            cut_frontier = self._cut_frontier \
                if self._cut_entries else frontier
        actors["planner"] = new_entries["planner"]
        ledger_entry = self._write_ledger_blob(step, cut.get("ledger"))
        return self._commit_epoch(step, actors, ledger_entry, cut_frontier)

    def adopt_cut(self, manifest: dict) -> None:
        """Carry a resumed-from manifest's actor blob set forward: until
        this incarnation captures its own actor cut, planner-only commits
        keep referencing the inherited (still consistent, still on disk)
        blobs, so no epoch is ever missing loader state."""
        with self._lock:
            self._cut_entries = {
                n: dict(e) for n, e in manifest.get("actors", {}).items()
                if n != "planner"}
            self._cut_frontier = int(
                manifest.get("frontier", manifest.get("step", -1)))

    def _gc(self) -> None:
        """Retention: keep the newest ``keep_epochs`` manifests plus every
        blob any retained manifest (or the in-flight index) references."""
        files = self._manifest_files()
        keep, drop = files[-self.keep_epochs:], files[:-self.keep_epochs]
        referenced: set[str] = set()
        for _epoch, path in keep:
            try:
                with open(path, encoding="utf-8") as f:
                    doc = json.load(f)
            except (OSError, ValueError):
                continue
            entries = list(doc.get("actors", {}).values())
            if doc.get("ledger"):
                entries.append(doc["ledger"])
            for e in entries:
                referenced.add(os.path.basename(e.get("blob", "")))
        with self._lock:
            referenced |= {os.path.basename(e["blob"])
                           for e in self._blob_index.values()}
            referenced |= {os.path.basename(e["blob"])
                           for e in self._cut_entries.values()}
        for _epoch, path in drop:
            try:
                os.remove(path)
            except OSError:
                pass
        bdir = self._blobs_dir()
        if os.path.isdir(bdir):
            for fn in os.listdir(bdir):
                if fn.endswith(".ckpt") and fn not in referenced:
                    try:
                        os.remove(os.path.join(bdir, fn))
                    except OSError:
                        pass

    # ------------------------------------------------------------- saves
    def _should(self, kind: str, step: int) -> bool:
        every = self.planner_every if kind == "planner" else \
            self.loader_every
        return step % max(every, 1) == 0

    def maybe_save(self, kind: str, name: str, step: int,
                   handle: ActorHandle) -> bool:
        if not self._should(kind, step) or not handle.alive:
            return False
        try:
            state = handle.call("checkpoint_state", timeout=10)
            blob = pickle.dumps({"step": step, "state": state})
        except Exception as e:
            # a missed save widens the replay window; count it so
            # operators (and the chaos soak) can see recovery debt grow
            with self._lock:
                self._save_failures[name] += 1
                self._last_failure[name] = f"{type(e).__name__}: {e}"
            return False
        with self._lock:
            self._mem[name] = (step, blob)
            self._saves[name] += 1
        if self.root:
            if self.is_fenced():
                # zombie incarnation: its state must never reach disk
                with self._lock:
                    self._fenced_writes += 1
                return False
            try:
                self._write_blob(name, step, blob)
            except OSError as e:
                with self._lock:
                    self._save_failures[name] += 1
                    self._last_failure[name] = f"{type(e).__name__}: {e}"
                return False
        return True

    # ------------------------------------------------------------- loads
    def load(self, name: str) -> Optional[dict]:
        """Newest known state for ``name``: memory, then the newest
        consistent on-disk manifest, then orphan/legacy ``.ckpt`` files.
        Corrupt data is counted in ``stats()['load_failures']`` and
        falls back instead of raising."""
        if self.restore_delay_s:
            time.sleep(self.restore_delay_s)
        with self._lock:
            if name in self._mem:
                blob = self._mem[name][1]
            else:
                blob = None
        if blob is not None:
            out = self._decode(name, blob)
            if out is not None:
                return out
        return self._load_from_disk(name)

    def _load_from_disk(self, name: str) -> Optional[dict]:
        if not self.root:
            return None
        man = self.latest_manifest()
        if man is not None and name in man["actors"]:
            out = self.load_from_manifest(man, name)
            if out is not None:
                return out
        if man is None:
            # no committed epoch at all: trust self-verifying orphan
            # blobs (maybe_save without commit_manifest)
            entry = self._newest_orphan_blob(name)
            if entry is not None:
                out = self._load_entry(name, entry, verify_index=False)
                if out is not None:
                    return out
        # legacy flat file (pre-manifest layout)
        path = os.path.join(self.root, f"{name}.ckpt")
        if os.path.exists(path):
            try:
                with open(path, "rb") as f:
                    return self._decode(name, f.read())
            except OSError as e:
                self._count_load_failure(name, e)
        return None

    def load_from_manifest(self, manifest: dict,
                           name: str) -> Optional[dict]:
        """Load one actor's blob as referenced by ``manifest``.  A blob
        that fails verification is counted and yields None."""
        entry = (manifest or {}).get("actors", {}).get(name)
        if entry is None:
            return None
        if self.restore_delay_s:   # simulated persistent-store read RTT
            time.sleep(self.restore_delay_s)
        return self._load_entry(name, entry)

    def load_ledger(self, manifest: dict) -> Optional[object]:
        """The DeliveryLedger snapshot committed with ``manifest``."""
        entry = (manifest or {}).get("ledger")
        if not entry:
            return None
        return self._load_entry(LEDGER_KEY, entry)

    def _load_entry(self, name: str, entry: dict,
                    verify_index: bool = True) -> Optional[dict]:
        try:
            if verify_index:
                payload = self._read_entry_payload(entry)
            else:
                path = os.path.join(self.root, entry["blob"])
                with open(path, "rb") as f:
                    payload = unframe_blob(f.read())
            return pickle.loads(payload)
        except Exception as e:
            self._count_load_failure(name, e)
            return None

    def _newest_orphan_blob(self, name: str) -> Optional[dict]:
        bdir = self._blobs_dir()
        if not os.path.isdir(bdir):
            return None
        safe = name.replace(os.sep, "_")
        best: Optional[tuple[int, str]] = None
        for fn in os.listdir(bdir):
            if not fn.startswith(f"{safe}@"):
                continue
            m = _BLOB_STEP_RE.search(fn)
            if m and (best is None or int(m.group(1)) > best[0]):
                best = (int(m.group(1)), fn)
        if best is None:
            return None
        return {"step": best[0], "blob": os.path.join("blobs", best[1])}

    def checkpointed_step(self, name: str) -> int:
        """Step of the newest checkpoint for ``name`` — consults DISK
        (manifest chain, then orphan/legacy files) when this process has
        no in-memory record, so a restarted job sizes its replay window
        from what actually survived, not from -1."""
        with self._lock:
            if name in self._mem:
                return self._mem[name][0]
            if name in self._blob_index:
                return self._blob_index[name]["step"]
        if not self.root:
            return -1
        man = self.latest_manifest()
        if man is not None and name in man["actors"]:
            return int(man["actors"][name]["step"])
        entry = self._newest_orphan_blob(name)
        if entry is not None:
            return int(entry["step"])
        path = os.path.join(self.root, f"{name}.ckpt")
        if os.path.exists(path):
            try:
                with open(path, "rb") as f:
                    doc = self._decode(name, f.read())
            except OSError:
                doc = None
            if isinstance(doc, dict) and "step" in doc:
                return int(doc["step"])
        return -1

    # ------------------------------------------------------------- stats
    def stats(self) -> dict:
        with self._lock:
            steps = {n: e["step"] for n, e in self._blob_index.items()
                     if n != LEDGER_KEY}
            steps.update({n: s for n, (s, _) in self._mem.items()})
            return {
                "saves": dict(self._saves),
                "save_failures": dict(self._save_failures),
                "load_failures": dict(self._load_failures),
                "last_failure": dict(self._last_failure),
                "checkpointed_steps": steps,
                "epoch": self._epoch,
                "fence_token": self._fence_token,
                "fenced_writes": self._fenced_writes,
                "manifests_committed": self._manifests_committed,
                "manifest_fallbacks": self._manifest_fallbacks,
            }


class ShadowManager:
    """Maintains one warm shadow per active Source Loader.

    Sync model: after every plan the orchestrator calls ``sync(name)``,
    which mirrors the active loader's checkpoint state into the shadow
    (cheap: in-process actor message).  On failure, ``promote`` swaps the
    shadow in — it already holds the buffer, so the next plan proceeds
    without touching storage; plans issued AFTER the last successful sync
    must then be replayed against the promoted shadow (the supervisor
    does this with the Planner's history window) or the same samples
    would be delivered twice.
    """

    def __init__(self, runtime: ActorRuntime,
                 make_loader: Callable[[str], SourceLoader]):
        self.runtime = runtime
        self.make_loader = make_loader
        self.shadows: dict[str, ActorHandle] = {}
        self.promotions: list[dict] = []
        self._synced_step: dict[str, int] = {}
        self._sync_failures: collections.Counter = collections.Counter()
        self._last_step_seen = -1

    def ensure_shadow(self, name: str) -> ActorHandle:
        if name in self.shadows and self.shadows[name].alive:
            return self.shadows[name]
        h = self.runtime.spawn(f"{name}::shadow", self.make_loader(name))
        self.shadows[name] = h
        return h

    def sync(self, name: str, active: ActorHandle,
             step: Optional[int] = None) -> bool:
        if step is not None:
            self._last_step_seen = max(self._last_step_seen, step)
        sh = self.shadows.get(name)
        if sh is None or not sh.alive or not active.alive:
            return False
        try:
            state = active.call("checkpoint_state", timeout=10)
            sh.cast("restore_state", state)
        except Exception:
            # shadow goes stale by one sync period; count it — staleness
            # is exactly the replay debt promote() inherits
            self._sync_failures[name] += 1
            return False
        if step is not None:
            self._synced_step[name] = step
        return True

    def synced_step(self, name: str) -> int:
        """Last step whose state the shadow is known to hold (-1: never)."""
        return self._synced_step.get(name, -1)

    def promote(self, name: str) -> Optional[ActorHandle]:
        sh = self.shadows.pop(name, None)
        if sh is None or not sh.alive:
            return None
        self.runtime.reassign(f"{name}::shadow", name)
        self.promotions.append({"name": name, "time": time.time(),
                                "synced_step": self.synced_step(name)})
        # the NEXT shadow for this name starts unsynced; leaving the old
        # step here would make a second promotion replay too little
        self._synced_step.pop(name, None)
        return sh

    def stats(self) -> dict:
        staleness = {
            name: (self._last_step_seen - self._synced_step.get(name, -1))
            for name in self.shadows}
        return {
            "sync_failures": dict(self._sync_failures),
            "synced_steps": dict(self._synced_step),
            "staleness_steps": staleness,
            "promotions": len(self.promotions),
        }


def shadow_memory_bytes(mgr: ShadowManager) -> int:
    """Reported separately — the paper excludes shadow memory from the
    fair comparison (§7.1) but we surface it for completeness."""
    return sum(h.memory_bytes() for h in mgr.shadows.values() if h.alive)
