"""Lightweight actor runtime (the paper builds on Ray; DESIGN.md §2).

Semantics kept from the paper's needs: named actors with isolated state and
a mailbox thread, async ``cast`` / sync ``call`` with futures, abrupt
``kill`` (simulated crash: pending mail dropped, no cleanup), heartbeat
supervision with failure callbacks, and memory introspection for the
resource benchmarks.  On a real cluster this class is the only thing to
swap for Ray/K8s actors.
"""
from __future__ import annotations

import queue
import threading
import time
import traceback
from concurrent.futures import Future, InvalidStateError
from typing import Any, Callable, Optional

from repro_torch.core.resilience import RetryPolicy
from repro_torch.telemetry import Telemetry, ensure_telemetry


class ActorDied(RuntimeError):
    pass


class Actor:
    """Base class.  Subclasses define plain methods; they run on the actor
    thread, one message at a time (no locks needed on actor state)."""

    name: str = "actor"

    # lifecycle hooks ---------------------------------------------------
    def on_start(self) -> None: ...
    def on_stop(self) -> None: ...

    # checkpoint hooks (fault.py) --------------------------------------
    def checkpoint_state(self) -> Any:
        return None

    def restore_state(self, state: Any) -> None: ...

    # resource accounting ----------------------------------------------
    def memory_bytes(self) -> int:
        return 0


class _Mail:
    __slots__ = ("method", "args", "kwargs", "future")

    def __init__(self, method, args, kwargs, future):
        self.method = method
        self.args = args
        self.kwargs = kwargs
        self.future = future


class ActorHandle:
    def __init__(self, name: str, actor: Actor, runtime: "ActorRuntime"):
        self.name = name
        self._actor = actor
        self._runtime = runtime
        self._telemetry = runtime.telemetry
        self._mailbox: queue.Queue = queue.Queue()
        self._alive = threading.Event()
        self._killed = threading.Event()
        self._hung = False
        self._current_mail: Optional[_Mail] = None
        self._thread = threading.Thread(
            target=self._loop, name=f"actor:{name}", daemon=True)

    # -- lifecycle -------------------------------------------------------
    def _start(self):
        self._alive.set()
        self._thread.start()

    def _loop(self):
        try:
            self._actor.on_start()
        except Exception:
            traceback.print_exc()
            self._alive.clear()
            return
        while not self._killed.is_set():
            try:
                mail = self._mailbox.get(timeout=0.05)
            except queue.Empty:
                continue
            if mail is None:
                break
            if self._killed.is_set():
                self._fail_mail(mail)
                break
            self._current_mail = mail
            try:
                fn = getattr(self._actor, mail.method)
                # span on the mailbox thread: the actor-side timeline in
                # the Chrome trace (caller side is the actor.call span)
                with self._telemetry.span("actor.exec", actor=self.name,
                                          method=mail.method):
                    result = fn(*mail.args, **mail.kwargs)
                if mail.future is not None:
                    try:
                        mail.future.set_result(result)
                    except InvalidStateError:
                        pass   # kill() failed this future while in flight
            except Exception as e:  # actor method raised
                if mail.future is not None:
                    try:
                        mail.future.set_exception(e)
                    except InvalidStateError:
                        pass
                else:
                    traceback.print_exc()
            finally:
                self._current_mail = None
        try:
            if not self._killed.is_set():
                self._actor.on_stop()
        finally:
            self._alive.clear()
            self._drain_mailbox()

    def _fail_mail(self, mail):
        if mail is not None and mail.future is not None \
                and not mail.future.done():
            try:
                mail.future.set_exception(ActorDied(
                    f"actor {self.name} died with mail pending"))
            except InvalidStateError:
                pass

    def _drain_mailbox(self):
        """A dead actor must not leave callers blocked on futures."""
        while True:
            try:
                self._fail_mail(self._mailbox.get_nowait())
            except queue.Empty:
                return

    @property
    def alive(self) -> bool:
        # killed counts as dead immediately: the actor thread may take a
        # while to notice (it could be wedged mid-method), and callers
        # probing alive must not enqueue into a mailbox nobody will drain
        return self._alive.is_set() and not self._killed.is_set()

    @property
    def hung(self) -> bool:
        """True when stop() timed out joining the actor thread."""
        return self._hung

    def kill(self):
        """Simulated crash: no cleanup, pending mail dropped.  In-flight
        and queued calls fail immediately with ActorDied instead of
        blocking until their timeout."""
        self._killed.set()
        self._fail_mail(self._current_mail)
        self._drain_mailbox()

    def stop(self, timeout: float = 5.0):
        """Graceful stop: drain then on_stop().  A join timeout means the
        actor thread is wedged: mark the handle dead (and hung) so the
        runtime's failure callbacks fire instead of silently leaking a
        zombie."""
        self._mailbox.put(None)
        self._thread.join(timeout=timeout)
        if self._thread.is_alive():
            self._hung = True
            self._killed.set()
            self._alive.clear()
            self._fail_mail(self._current_mail)
            self._drain_mailbox()
        else:
            self._alive.clear()

    # -- messaging -------------------------------------------------------
    def call(self, method: str, *args, timeout: Optional[float] = 30.0,
             retry: Optional[RetryPolicy] = None, **kwargs):
        """Synchronous call.  With ``retry`` set, retryable failures
        (timeouts, transient IO errors raised by the method) are retried
        with the policy's backoff; ActorDied is NOT retryable here — a
        dead handle stays dead, use ActorRuntime.call_with_retry to chase
        supervised respawns by name."""
        tel = self._telemetry
        if not tel.enabled:
            if retry is None:
                return self._call_once(method, args, kwargs, timeout)
            return retry.run(self._call_once, method, args, kwargs, timeout)
        t0 = time.perf_counter()
        with tel.span("actor.call", actor=self.name, method=method):
            tel.inc("actor_calls_total", 1.0, actor=self.name,
                    method=method)
            try:
                if retry is None:
                    result = self._call_once(method, args, kwargs, timeout)
                else:
                    result = retry.run(
                        self._call_once, method, args, kwargs, timeout,
                        on_retry=lambda attempt, exc: tel.inc(
                            "actor_retries_total", 1.0, actor=self.name,
                            method=method))
            except Exception:
                tel.inc("actor_call_failures_total", 1.0, actor=self.name,
                        method=method)
                raise
        tel.observe("actor_call_seconds", time.perf_counter() - t0,
                    method=method)
        return result

    def _call_once(self, method: str, args: tuple, kwargs: dict,
                   timeout: Optional[float]):
        if not self.alive:
            raise ActorDied(f"actor {self.name} is dead")
        fut: Future = Future()
        self._mailbox.put(_Mail(method, args, kwargs, fut))
        return fut.result(timeout=timeout)

    def call_async(self, method: str, *args, **kwargs) -> Future:
        if not self.alive:
            raise ActorDied(f"actor {self.name} is dead")
        tel = self._telemetry
        if tel.enabled:
            tel.inc("actor_async_calls_total", 1.0, actor=self.name,
                    method=method)
        fut: Future = Future()
        self._mailbox.put(_Mail(method, args, kwargs, fut))
        return fut

    def cast(self, method: str, *args, **kwargs) -> None:
        if not self.alive:
            raise ActorDied(f"actor {self.name} is dead")
        tel = self._telemetry
        if tel.enabled:
            tel.inc("actor_casts_total", 1.0, actor=self.name,
                    method=method)
        self._mailbox.put(_Mail(method, args, kwargs, None))

    # -- introspection ----------------------------------------------------
    def memory_bytes(self) -> int:
        if not self.alive:
            return 0
        try:
            return self.call("memory_bytes", timeout=10)
        except Exception:
            return 0

    @property
    def mailbox_depth(self) -> int:
        return self._mailbox.qsize()


class _FanCall:
    __slots__ = ("handle", "method", "args", "kwargs", "timeout", "retry",
                 "attempt", "future")

    def __init__(self, handle, method, args, kwargs, timeout, retry):
        self.handle = handle
        self.method = method
        self.args = args
        self.kwargs = kwargs
        self.timeout = timeout
        self.retry = retry
        self.attempt = 0
        self.future: Optional[Future] = None


class FanOut:
    """One overlapped wave of ``call_async`` RPCs across many handles.

    ``submit()`` enqueues the call on every target's mailbox immediately
    (no round-trip); ``gather()`` then collects the futures, so the wave
    costs one max-latency instead of a sum of round-trips.  Per-call
    RetryPolicy semantics match ``ActorHandle.call``: a retryable failure
    (timeout, transient IO error raised by the method) re-submits THAT
    call with the policy's backoff; ``ActorDied`` stays terminal — a dead
    handle does not resurrect under the same object, so chasing respawns
    is ``ActorRuntime.call_with_retry``'s job.  Calls that still fail
    after retries land in ``failures`` keyed like their results would
    have been; ``gather()`` never raises.
    """

    def __init__(self, telemetry: Optional["Telemetry"] = None):
        self.telemetry = ensure_telemetry(telemetry)
        self._calls: "dict[Any, _FanCall]" = {}
        self.failures: "dict[Any, BaseException]" = {}

    def submit(self, key, handle: "ActorHandle", method: str, *args,
               timeout: Optional[float] = 30.0,
               retry: Optional[RetryPolicy] = None, **kwargs) -> None:
        call = _FanCall(handle, method, args, kwargs, timeout, retry)
        self._start(key, call)
        self._calls[key] = call

    def _start(self, key, call: _FanCall) -> None:
        call.attempt += 1
        try:
            call.future = call.handle.call_async(
                call.method, *call.args, **call.kwargs)
        except Exception as e:       # dead handle: fail at submit time
            call.future = None
            self.failures[key] = e

    def gather(self) -> dict:
        """Collect the wave.  Returns ``{key: result}`` for successes;
        failed calls (after per-call retries) are in ``failures``."""
        tel = self.telemetry
        results = {}
        with tel.span("actor.fanout", calls=len(self._calls)):
            for key, call in self._calls.items():
                while call.future is not None:
                    try:
                        results[key] = call.future.result(
                            timeout=call.timeout)
                        break
                    except Exception as e:
                        retry = call.retry
                        retryable = (retry is not None
                                     and retry.is_retryable(e)
                                     and call.attempt < retry.max_attempts)
                        if not retryable:
                            self.failures[key] = e
                            tel.inc("fanout_call_failures_total", 1.0,
                                    method=call.method)
                            break
                        tel.inc("actor_retries_total", 1.0,
                                actor=call.handle.name, method=call.method)
                        time.sleep(retry.delay(call.attempt - 1))
                        self._start(key, call)
        self._calls.clear()
        return results


class ActorRuntime:
    """Spawns actors, supervises liveness, reports fleet memory."""

    def __init__(self, heartbeat_interval: float = 0.05,
                 telemetry: Optional[Telemetry] = None):
        self.telemetry = ensure_telemetry(telemetry)
        self._actors: dict[str, ActorHandle] = {}
        self._lock = threading.Lock()
        self._failure_cbs: list[Callable[[str, ActorHandle], None]] = []
        self._hb_interval = heartbeat_interval
        self._stop = threading.Event()
        self._reported_dead: set[str] = set()
        self._monitor = threading.Thread(
            target=self._monitor_loop, name="actor-monitor", daemon=True)
        self._monitor.start()

    def spawn(self, name: str, actor: Actor) -> ActorHandle:
        actor.name = name
        handle = ActorHandle(name, actor, self)
        with self._lock:
            if name in self._actors and self._actors[name].alive:
                raise ValueError(f"actor {name!r} already running")
            self._actors[name] = handle
            self._reported_dead.discard(name)
        handle._start()
        return handle

    def get(self, name: str) -> ActorHandle:
        with self._lock:
            return self._actors[name]

    def reassign(self, old: str, new: str) -> ActorHandle:
        """Re-register a live actor under a new name (shadow promotion)."""
        with self._lock:
            h = self._actors.pop(old)
            h.name = new
            h._actor.name = new
            self._actors[new] = h
            self._reported_dead.discard(new)
            return h

    def on_failure(self, cb: Callable[[str, ActorHandle], None]):
        self._failure_cbs.append(cb)

    def call_with_retry(self, name: str, method: str, *args,
                        retry: Optional[RetryPolicy] = None,
                        timeout: Optional[float] = 30.0, **kwargs):
        """call() that re-resolves the handle by NAME on every attempt, so
        it rides through supervised respawns and shadow promotions (where
        the name is remapped to a fresh handle).  ActorDied and missing
        names are therefore retryable at this level."""
        if retry is None:
            retry = RetryPolicy(retryable=RetryPolicy().retryable
                                + (ActorDied, KeyError))
        elif not any(issubclass(ActorDied, r) for r in retry.retryable):
            retry = RetryPolicy(**{**retry.__dict__,
                                   "retryable": tuple(retry.retryable)
                                   + (ActorDied, KeyError)})

        def _attempt():
            return self.get(name).call(method, *args, timeout=timeout,
                                       **kwargs)
        return retry.run(_attempt)

    def _monitor_loop(self):
        while not self._stop.is_set():
            time.sleep(self._hb_interval)
            with self._lock:
                items = list(self._actors.items())
            for name, h in items:
                if not h.alive and h._killed.is_set() \
                        and name not in self._reported_dead:
                    self._reported_dead.add(name)
                    self.telemetry.inc("actor_deaths_total", 1.0,
                                       actor=name)
                    for cb in self._failure_cbs:
                        try:
                            cb(name, h)
                        except Exception:
                            traceback.print_exc()

    def actors(self) -> dict[str, ActorHandle]:
        with self._lock:
            return dict(self._actors)

    def memory_report(self) -> dict[str, int]:
        return {n: h.memory_bytes() for n, h in self.actors().items()
                if h.alive}

    def shutdown(self):
        self._stop.set()
        for h in self.actors().values():
            if h.alive:
                h.stop()

    def terminate(self):
        """Abrupt whole-runtime death (process-crash analog): every actor
        is killed with pending mail dropped, no on_stop, and — unlike
        individual kills — NO failure callbacks fire, because the
        supervisor died with the process.  Recovery must come from disk
        (Overlord.resume), not from in-process supervision."""
        self._failure_cbs.clear()
        self._stop.set()
        for h in self.actors().values():
            h.kill()
