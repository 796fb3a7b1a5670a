"""Worker supervision: bounded-backoff respawn with a crash-loop breaker.

One :class:`WorkerSupervisor` owns one worker process.  Its ``spawn``
callable returns a process handle (anything with ``poll() -> exit code or
None``, ``terminate()``, ``kill()``, ``wait(timeout)`` — ``subprocess.Popen``
verbatim; tests inject fakes), and each supervision tick asks: still
running?  If not, the crash is recorded against a sliding window:

- fewer than ``max_crashes`` crashes inside ``crash_window`` seconds →
  sleep the bounded exponential backoff (``base_delay * multiplier**streak``
  capped at ``max_delay``) and respawn; ``frontend_replica_restarts_total``
  counts it.  The respawned worker re-registers its lease under a NEW
  epoch, so the membership plane never confuses it with its dead
  incarnation.
- ``max_crashes`` crashes in the window → the replica is **quarantined**:
  no further respawns, ``frontend_replica_quarantines_total`` fires, the
  member's lease is evicted from the membership group (when the supervisor
  holds a ``membership`` handle) so routers drop it on their next sync
  instead of waiting out the TTL, and the optional ``on_quarantine`` alert
  hook runs once.  A human (or a higher-level operator loop)
  un-quarantines by calling :meth:`reset`.

Clock and sleep are injectable, and :meth:`tick` is a plain synchronous
step — the deterministic tests drive crash schedules through fake handles
and a fake clock with zero wall time.  :meth:`start` wraps ``tick`` in a
daemon thread (joined by :meth:`stop`) for real deployments.
"""
from __future__ import annotations

import threading
import time
from collections import deque

from ... import observability as _obs

__all__ = ["WorkerSupervisor"]

RUNNING, RESPAWNED, QUARANTINED, STOPPED = (
    "running", "respawned", "quarantined", "stopped")


class WorkerSupervisor:
    """Keep one worker process alive until it crash-loops."""

    def __init__(self, spawn, name="worker", base_delay=0.1, max_delay=5.0,
                 multiplier=2.0, crash_window=30.0, max_crashes=5,
                 clock=time.monotonic, sleep=time.sleep, on_quarantine=None,
                 membership=None):
        """``membership``: optional
        :class:`~paddle_tpu_torch.distributed.membership.MembershipService`
        handle for the worker's group.  A quarantine then proactively
        ``evict()``s the worker's lease — the dead incarnation cannot
        release it, and without eviction the router keeps selecting the
        quarantined member until the TTL expires it."""
        if max_crashes < 1:
            raise ValueError("max_crashes must be >= 1")
        self.spawn = spawn
        self.name = str(name)
        self.membership = membership
        self.base_delay = float(base_delay)
        self.max_delay = float(max_delay)
        self.multiplier = float(multiplier)
        self.crash_window = float(crash_window)
        self.max_crashes = int(max_crashes)
        self.clock = clock
        self.sleep = sleep
        self.on_quarantine = on_quarantine
        self.proc = None
        self.restarts = 0
        self.quarantined = False
        self.stopped = False
        self._crashes = deque()        # clock() stamps inside the window
        self._thread = None
        self._stop = threading.Event()
        self._lock = threading.Lock()

    # ---- supervision ---------------------------------------------------------
    def start_worker(self):
        """Spawn the initial worker (idempotent)."""
        with self._lock:
            if self.proc is None and not self.stopped:
                self.proc = self.spawn()
        return self

    def tick(self):
        """One supervision step; returns the resulting state string.

        Synchronous and injectable-clock deterministic: a crashed child is
        either respawned (after the backoff ``sleep``) or quarantined right
        here."""
        delay = None
        with self._lock:
            if self.stopped:
                return STOPPED
            if self.quarantined:
                return QUARANTINED
            if self.proc is None:
                self.proc = self.spawn()
                return RESPAWNED
            if self.proc.poll() is None:
                return RUNNING
            # child exited without us stopping it: a crash
            now = float(self.clock())
            self._crashes.append(now)
            while self._crashes and now - self._crashes[0] > self.crash_window:
                self._crashes.popleft()
            if len(self._crashes) >= self.max_crashes:
                self.quarantined = True
                self.proc = None
                _obs.FRONTEND_QUARANTINES.inc(replica=self.name)
                hook = self.on_quarantine
                # evict the dead incarnation's lease NOW (outside the lock —
                # store round-trips): watchers see `leave` on their next
                # poll instead of routing to a quarantined member for the
                # rest of the TTL
            else:
                self.proc = None
                streak = len(self._crashes) - 1
                delay = min(self.max_delay,
                            self.base_delay * self.multiplier ** streak)
        if delay is not None:
            # backoff OUTSIDE the lock: a concurrent stop()/reset() must
            # not block behind up to max_delay of sleep, and a stop that
            # lands mid-backoff wins — re-check before respawning
            self.sleep(delay)
            with self._lock:
                if self.stopped:
                    return STOPPED
                if self.quarantined:
                    return QUARANTINED
                self.proc = self.spawn()
                self.restarts += 1
            _obs.FRONTEND_RESTARTS.inc(replica=self.name)
            return RESPAWNED
        if self.membership is not None:
            try:
                self.membership.evict(self.name)
            except (OSError, ConnectionError, TimeoutError):
                pass  # store unreachable: the TTL expiry path still reaps
        if hook is not None:
            hook(self)
        return QUARANTINED

    def reset(self):
        """Clear quarantine + crash history (operator action); the next
        :meth:`tick` respawns."""
        with self._lock:
            self.quarantined = False
            self._crashes.clear()

    # ---- background loop -----------------------------------------------------
    def start(self, interval=0.2):
        """Run :meth:`tick` every ``interval`` seconds in a daemon thread
        until :meth:`stop` (which joins it)."""
        self.start_worker()
        if self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._loop, args=(float(interval),),
                name=f"supervisor-{self.name}", daemon=True)
            self._thread.start()
        return self

    def _loop(self, interval):
        while not self._stop.wait(interval):
            if self.tick() in (QUARANTINED, STOPPED):
                return

    def stop(self, term_timeout=10.0):
        """Stop supervising and shut the child down: SIGTERM (graceful
        drain), bounded wait, SIGKILL as the backstop."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None
        with self._lock:
            self.stopped = True
            proc, self.proc = self.proc, None
        if proc is not None and proc.poll() is None:
            proc.terminate()
            try:
                proc.wait(timeout=term_timeout)
            except Exception:
                proc.kill()
                proc.wait(timeout=5.0)
