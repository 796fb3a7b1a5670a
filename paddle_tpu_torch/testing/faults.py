"""Deterministic fault injection — named fault points with seeded schedules.

Production code declares *fault points* — ``FAULTS.fire("serving.page_alloc")``
at the spot where an allocation could fail, ``FAULTS.raise_if("serving.step",
rids=[...])`` where a dispatch could blow up — and pays one dict-emptiness
check while nothing is installed.  Tests arm a point with a schedule:

    from paddle_tpu_torch.testing import FAULTS, FailNth, FailProb

    FAULTS.install("serving.page_alloc", FailNth(3))          # 3rd call fails
    FAULTS.install("serving.step", FailProb(0.2, seed=7))     # seeded coin
    FAULTS.install("serving.step", FailNth(1), transient=True,
                   match=lambda ctx: 42 in ctx.get("rids", ()))
    ...
    FAULTS.reset()

or scoped with the context manager::

    with injected("store.connect", FailNth({1, 2})):
        ...

Schedules are pure functions of their own call counter (plus a seeded RNG for
:class:`FailProb`), so a chaos test replays the exact same failure sequence
every run.  Known points today: ``serving.page_alloc`` (allocation returns
dry), ``serving.step`` (dispatch raises :class:`InjectedFault`),
``serving.slow_step`` (dispatch stalls ``delay`` seconds),
``serving.kv_handoff`` (disaggregated prefill→decode page transfer raises
before any page is copied, so a transient retry is idempotent; ctx has
``rids`` and ``path`` — ``local`` for the in-process gather→device_put hop,
``cross_host`` when the pool pulls a serialized block off a remote prefill
worker, where the fault fires pool-side BEFORE the pull RPC so a retry
re-pulls a block the worker still holds), ``store.connect``
(client connect raises); in the serving front door, ``frontend.route``
(gateway submit fails before routing), ``frontend.submit`` (fails after a
replica is chosen; ctx has ``replica``), ``frontend.step`` (a replica's
step loop dies — the chaos tests kill a replica mid-stream with this; ctx
has ``replica``), and ``frontend.resume`` (the durable-resume attempt for a
partially-streamed request fails — the only path on which such a request
may end FAILED; ctx has the dead ``replica``).  The durable request plane
adds ``journal.append`` (a write-ahead journal record fails to append; ctx
has ``kind``), ``journal.fsync`` (the fsync after a critical append raises
— a full-disk / dying-device stand-in), and ``gateway.recover`` (the
re-drive of one journaled non-terminal request during gateway crash
recovery fails; ctx has ``key``).  The self-healing fleet adds
``membership.register`` /
``membership.heartbeat`` (lease registration / renewal attempts raise; ctx
has ``group`` and ``member`` — arm ``Always`` to starve a lease to death)
and ``rpc.send`` / ``rpc.recv`` (the worker RPC channel fails client-side
around the request/response halves; ctx has ``op``).  The KV-cache
hierarchy adds ``kv.spill`` (the device→host page copy behind an LRU
reclaim raises; transient firings retry, poison degrades to a plain
eviction — recompute on the next hit; ctx has ``page``), ``kv.restore``
(the host→device restore of a spilled chain raises before any page is
written; poison falls back to re-prefill; ctx has ``keys``), and
``kv.peer_pull`` (the gateway-driven peer page pull fails before the
export RPC; poison submits the request cold — recompute; ctx has
``replica`` and ``holder``).  The registry itself stays name-keyed and
open, but every point production code fires must be listed in
:data:`KNOWN_POINTS` — graftlint's ``contracts`` pass (CT103) checks that
each fired string is declared here and that each declared string has
chaos coverage, so the table is the single source of truth for the
fault-point protocol.
"""
from __future__ import annotations

import random
import threading
from contextlib import contextmanager

__all__ = ["InjectedFault", "FailNth", "FailProb", "Always", "Never",
           "FaultPoint", "FaultInjector", "FAULTS", "KNOWN_POINTS",
           "injected"]

# the declared fault-point protocol: every name production code fires.
# graftlint CT103 enforces parity both ways (fired => declared here,
# declared => fired somewhere and armed by an injected(...) chaos test).
KNOWN_POINTS = frozenset({
    "serving.page_alloc",
    "serving.step",
    "serving.slow_step",
    "serving.kv_handoff",
    "store.connect",
    "frontend.route",
    "frontend.submit",
    "frontend.step",
    "frontend.resume",
    "journal.append",
    "journal.fsync",
    "gateway.recover",
    "membership.register",
    "membership.heartbeat",
    "rpc.send",
    "rpc.recv",
    "kv.spill",
    "kv.restore",
    "kv.peer_pull",
})


class InjectedFault(RuntimeError):
    """Raised by an armed fault point. ``transient`` marks errors the
    consuming subsystem should treat as retryable (the serving engine routes
    those through its backoff path instead of quarantining a request)."""

    def __init__(self, point, transient=False):
        super().__init__(f"injected fault at {point!r}"
                         + (" (transient)" if transient else ""))
        self.point = point
        self.transient = transient

    def __reduce__(self):
        # survive the worker RPC's pickle round trip with point/transient
        # intact (chaos tests assert on them gateway-side)
        return (InjectedFault, (self.point, self.transient))


# ---- schedules ---------------------------------------------------------------
class FailNth:
    """Fire on specific 1-based call numbers: ``FailNth(3)`` fails the third
    call only; ``FailNth({1, 2, 5})`` each listed call; ``FailNth(2, every=
    True)`` call 2 and every call after it."""

    def __init__(self, nth, every=False):
        self.nth = {int(nth)} if isinstance(nth, int) else {int(n) for n in nth}
        self.every = every
        self._floor = min(self.nth)

    def should_fire(self, n_call):
        if self.every:
            return n_call >= self._floor
        return n_call in self.nth


class FailProb:
    """Fire with probability ``p`` per call from a private seeded stream —
    chaotic in shape, bit-reproducible across runs."""

    def __init__(self, p, seed=0):
        if not 0.0 <= p <= 1.0:
            raise ValueError("p must be in [0, 1]")
        self.p = float(p)
        self._rng = random.Random(seed)

    def should_fire(self, n_call):
        return self._rng.random() < self.p


class Always:
    def should_fire(self, n_call):
        return True


class Never:
    def should_fire(self, n_call):
        return False


# ---- registry ----------------------------------------------------------------
class FaultPoint:
    """One armed point: a schedule, an optional context predicate, and the
    knobs consumers read off a firing (``transient``, ``delay``)."""

    def __init__(self, name, schedule, match=None, transient=False,
                 delay=0.0):
        self.name = name
        self.schedule = schedule
        self.match = match
        self.transient = transient
        self.delay = float(delay)
        self.calls = 0          # times the point was evaluated
        self.fires = 0          # times it actually fired

    def evaluate(self, ctx):
        if self.match is not None and not self.match(ctx):
            return False
        self.calls += 1
        if self.schedule.should_fire(self.calls):
            self.fires += 1
            return True
        return False


class FaultInjector:
    """Process-wide fault-point registry (usually the :data:`FAULTS`
    singleton).  ``fire`` is the hot-path probe: with nothing installed it is
    a single attribute read returning None."""

    def __init__(self):
        self._points: dict[str, FaultPoint] = {}
        self._mu = threading.Lock()

    # _points is read lock-free on the hot path BY DESIGN (see the class
    # docstring): production probes pay one dict read, installs/removes are
    # test-time and rare, and dict get/bool are atomic under the GIL.
    @property
    def active(self):
        return bool(self._points)  # graftlint: disable=concurrency

    def install(self, name, schedule, match=None, transient=False,
                delay=0.0) -> FaultPoint:
        point = FaultPoint(name, schedule, match=match, transient=transient,
                           delay=delay)
        with self._mu:
            self._points[name] = point
        return point

    def remove(self, name):
        with self._mu:
            self._points.pop(name, None)

    def reset(self):
        with self._mu:
            self._points.clear()

    def point(self, name) -> FaultPoint | None:
        return self._points.get(name)  # graftlint: disable=concurrency

    def fire(self, name, **ctx) -> FaultPoint | None:
        """Evaluate point ``name``; returns the :class:`FaultPoint` when it
        fires (so the caller can read ``delay``/``transient``), else None."""
        if not self._points:  # graftlint: disable=concurrency
            return None
        point = self._points.get(name)
        if point is None or not point.evaluate(ctx):
            return None
        return point

    def raise_if(self, name, **ctx):
        """Raise :class:`InjectedFault` when point ``name`` fires."""
        point = self.fire(name, **ctx)
        if point is not None:
            raise InjectedFault(name, transient=point.transient)

    def maybe_fire(self, name, **ctx):
        """The one-line production probe: :meth:`raise_if` behind the
        idle-path emptiness check, replacing the
        ``if FAULTS.active: FAULTS.raise_if(...)`` boilerplate at every
        fault point.  With nothing installed this is a single dict-emptiness
        read; armed, it raises :class:`InjectedFault` when ``name`` fires.
        One call shape also gives graftlint CT103 a single pattern to
        match for fault-point parity."""
        if not self._points:  # graftlint: disable=concurrency
            return
        self.raise_if(name, **ctx)


FAULTS = FaultInjector()


@contextmanager
def injected(name, schedule, match=None, transient=False, delay=0.0):
    """Arm ``name`` on the process singleton for the enclosed block; the
    point is removed (not reset-all) on exit so nested injections compose."""
    point = FAULTS.install(name, schedule, match=match, transient=transient,
                           delay=delay)
    try:
        yield point
    finally:
        FAULTS.remove(name)
