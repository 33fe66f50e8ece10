"""Trainer-side client with a prefetch ring buffer (§6.1, Fig. 16).

One client per trainer rank.  A background thread keeps ``prefetch``
steps buffered ahead of the training loop; ``get(step)`` blocks only on
true underflow and records the stall — the quantity the fault-tolerance
benchmark plots (data-fetch-latency spikes).
"""
from __future__ import annotations

import threading
import time
from typing import Callable, Optional


class TrainerClient:
    def __init__(self, rank: int, fetch: Callable[[int, int], Optional[dict]],
                 prefetch: int = 2, poll_interval: float = 0.002,
                 start_step: int = 0):
        self.rank = rank
        self._fetch = fetch            # (step, rank) -> view dict | None
        self.prefetch = prefetch
        self.poll = poll_interval
        self._buf: dict[int, dict] = {}
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        # start_step > 0 on job resume: steps before it were consumed by
        # the previous incarnation and must not be prefetched again
        self._next_wanted = start_step
        self._stop = threading.Event()
        self.stall_log: list[tuple[int, float]] = []   # (step, stall_s)
        self.fetch_log: list[tuple[int, float]] = []   # (step, fetch_s)
        self._thread = threading.Thread(
            target=self._loop, name=f"client-{rank}", daemon=True)
        self._thread.start()

    def _loop(self):
        while not self._stop.is_set():
            with self._lock:
                wanted = [s for s in range(self._next_wanted,
                                           self._next_wanted + self.prefetch)
                          if s not in self._buf]
            if not wanted:
                time.sleep(self.poll)
                continue
            for s in wanted:
                t0 = time.time()
                try:
                    view = self._fetch(s, self.rank)
                except Exception:
                    view = None
                if view is not None:
                    with self._cv:
                        self._buf[s] = view
                        self.fetch_log.append((s, time.time() - t0))
                        self._cv.notify_all()
                else:
                    time.sleep(self.poll)
                    break

    def get(self, step: int, timeout: float = 30.0) -> dict:
        t0 = time.time()
        with self._cv:
            self._next_wanted = max(self._next_wanted, step)
            while step not in self._buf:
                if not self._cv.wait(timeout=self.poll * 10):
                    pass
                if time.time() - t0 > timeout:
                    raise TimeoutError(
                        f"client {self.rank}: step {step} not delivered")
            view = self._buf.pop(step)
            self._next_wanted = step + 1
        stall = time.time() - t0
        self.stall_log.append((step, stall))
        return view

    def buffered(self) -> int:
        with self._lock:
            return len(self._buf)

    def close(self):
        self._stop.set()
        self._thread.join(timeout=2)
