"""Threaded engine replicas behind one thread-safe facade.

``LLMEngine`` is single-caller by design: ``step()`` mutates slot tables,
page refcounts, and the prefix index with no internal locking.  This module
keeps that invariant while serving many concurrent callers by giving each
replica ONE ``threading.Condition`` that serializes every engine touch — the
step loop holds it per step, and ``submit`` / ``cancel`` / ``health`` take
it per call.  Token DELIVERY does not ride that lock: each step publishes
new tokens and statuses into a per-request outbox under a light condition
of its own, and ``poll`` waits there — token latency stays one notify away
from the engine's cadence, and a timed poll keeps its deadline even while
a step holds the engine condition for seconds (jit compile, paced chaos
steps), which is what SSE keep-alive heartbeats ride on.

Replica death is a first-class event: when the step loop dies (an armed
``frontend.step`` fault, or an error that escapes the engine's own
step-isolation machinery) the replica finalizes every inflight request as
FAILED via ``LLMEngine.fail_all`` — streams observe a typed terminal status
instead of hanging — drops its prefix-key mirror from the router, and is
excluded from routing from then on.  With ``requeue=True`` the
:class:`ReplicaSet` turns that death into recovery instead: zero-streamed
requests requeue onto a survivor, partially-streamed ones resume with
their emitted history (see :meth:`ReplicaSet._resume`).

Fault points (see :mod:`paddle_tpu_torch.testing.faults`): ``frontend.route``
fires before routing, ``frontend.submit`` after a replica is chosen (ctx has
``replica``), ``frontend.step`` inside a replica's step loop (ctx has
``replica``) — the chaos tests use the last to kill a replica mid-stream —
and ``frontend.resume`` inside the durable-resume attempt (ctx has the dead
``replica``; arming it fails the one resume attempt, the only path on which
a partially-streamed request may end FAILED).
"""
from __future__ import annotations

import functools
import threading
import time
from concurrent.futures import ThreadPoolExecutor, as_completed

from ... import observability as _obs
from ...observability import flight as _flight
from ...core.retry import RetryPolicy, retry_call
from ...testing import faults as _faults
from ..serving import RequestStatus as _RequestStatus
from ..serving import prefix_page_keys
from .admission import AlwaysAdmit, ShedError
from .router import PrefixAffinityRouter

__all__ = ["ReplicaDeadError", "StuckStepError", "EngineReplica",
           "RequestHandle", "ReplicaSet"]


class _TransientPull(Exception):
    """Private wrapper around a transient ``kv.peer_pull`` error so
    :func:`retry_call` retries exactly those; any other failure abandons
    the pull and the request recomputes its prefix (lossless fallback)."""

    def __init__(self, err):
        # forward err itself (str() is identical for a 1-arg Exception) so
        # the default __reduce__ round-trips the wrapper by value (CT102)
        super().__init__(err)
        self.err = err


class ReplicaDeadError(RuntimeError):
    """Raised when submitting to a dead replica, or when no replica in the
    set is alive."""


class StuckStepError(RuntimeError):
    """A replica step exceeded ``step_wall_timeout`` — the watchdog promoted
    the gray failure (wedged device, deadlocked collective) to a typed
    replica death so inflight streams fail over instead of hanging."""


class _FairRLock:
    """A reentrant lock granted in arrival order: the lock under each
    replica's engine condition.

    The step loop releases the engine condition after every step and takes
    it again at once.  A ``threading.RLock`` lets that re-acquire barge
    past the threads already blocked on it (``submit``, ``status``,
    ``load``, a worker's RPC handlers), which can then starve for a whole
    stream.  Here a release hands the lock to the longest waiter, so every
    caller that queued during a step runs before the next step starts.
    Implements the hooks ``threading.Condition`` uses for a reentrant lock
    (``_is_owned``, ``_release_save``, ``_acquire_restore``)."""

    def __init__(self):
        self._mutex = threading.Lock()
        self._owner = None
        self._depth = 0
        self._queue = []          # [(thread ident, gate)], oldest first

    def acquire(self, blocking=True, timeout=-1):
        me = threading.get_ident()
        with self._mutex:
            if self._owner == me:
                self._depth += 1
                return True
            if self._owner is None and not self._queue:
                self._owner, self._depth = me, 1
                return True
            if not blocking:
                return False
            gate = threading.Lock()
            gate.acquire()
            entry = (me, gate)
            self._queue.append(entry)
        # the releaser sets _owner / _depth for us before opening the gate
        if gate.acquire(True, timeout):
            return True
        with self._mutex:
            if entry in self._queue:
                self._queue.remove(entry)
                return False
        gate.acquire()            # handed over as the wait timed out
        return True

    def release(self):
        with self._mutex:
            if self._owner != threading.get_ident():
                raise RuntimeError("cannot release un-acquired lock")
            self._depth -= 1
            if self._depth == 0:
                self._hand_off()

    def _hand_off(self):
        """Give the lock to the oldest waiter, or free it.  Caller holds
        ``_mutex`` and the lock is at depth 0."""
        if self._queue:
            ident, gate = self._queue.pop(0)
            self._owner, self._depth = ident, 1
            gate.release()
        else:
            self._owner = None

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()

    def _is_owned(self):
        return self._owner == threading.get_ident()

    def _release_save(self):
        with self._mutex:
            depth, self._depth = self._depth, 0
            self._hand_off()
        return depth

    def _acquire_restore(self, depth):
        self.acquire()
        with self._mutex:
            self._depth = depth


class EngineReplica:
    """One engine + the lock that makes it multi-caller safe + the thread
    that drives it.  All public methods are thread-safe.

    Token delivery is decoupled from the engine lock: after every step the
    loop PUBLISHES each request's new tokens and status into a per-request
    outbox guarded by its own light condition, and :meth:`poll` waits on
    that outbox alone.  The engine condition is held for a step's whole
    duration (first-call jit compile runs seconds; a fault-paced slow step
    sleeps inside it), and a lock release followed by an immediate
    re-acquire routinely barges past timed waiters — a poller contending on
    the engine lock can starve for an entire decode burst and then receive
    the whole batch at once.  Waiting on the outbox instead keeps timed
    polls inside their deadline (SSE heartbeats depend on this) and token
    latency at one notify."""

    def __init__(self, name, engine, router=None, poll_interval=0.05,
                 step_wall_timeout=None):
        self.name = str(name)
        self.engine = engine
        self.router = router
        self.alive = True
        self.error = None
        # granted in arrival order, so callers blocked during a step get
        # the engine before the loop's next step (see _FairRLock)
        self._cv = threading.Condition(_FairRLock())
        # rid -> {"toks": [undelivered], "status": last published} — written
        # by _publish (engine condition held), read/drained by poll under
        # the light condition only.  Lock order: engine cv, then outbox cv.
        self._out_cv = threading.Condition()
        self._out = {}
        self._stop = False
        self._thread = None
        self._poll = float(poll_interval)
        self.step_wall_timeout = (None if step_wall_timeout is None
                                  else float(step_wall_timeout))
        self._step_t0 = None        # monotonic start of the inflight step
        self._watchdog = None
        if router is not None:
            # called from inside step() while the step thread holds our
            # condition; the router only takes its own (leaf) lock.
            engine.cache_event_listener = (
                lambda event, key: router.note_event(self.name, event, key))

    # ---- lifecycle -----------------------------------------------------------
    def start(self):
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._loop, name=f"replica-{self.name}", daemon=True)
            self._thread.start()
        if self.step_wall_timeout is not None and self._watchdog is None:
            self._watchdog = threading.Thread(
                target=self._watch_steps, name=f"watchdog-{self.name}",
                daemon=True)
            self._watchdog.start()
        return self

    def close(self):
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None
        if self._watchdog is not None:
            self._watchdog.join(timeout=10.0)
            self._watchdog = None

    def _has_work(self):
        eng = self.engine
        return bool(eng._waiting) or any(s is not None for s in eng._slots)

    def _loop(self):
        # engine-side span events (prefill/decode/first_token/terminal) all
        # record from this thread — label them with the replica's name so a
        # merged trace shows which replica served each phase
        _flight.set_proc_label(f"replica:{self.name}")
        while True:
            with self._cv:
                if self._stop:
                    return
                if not self._has_work():
                    self._cv.wait(self._poll)
                    continue
                try:
                    _faults.FAULTS.maybe_fire("frontend.step",
                                              replica=self.name)
                    self._step_t0 = time.monotonic()
                    self.engine.step()
                except Exception as e:  # noqa: BLE001 — replica death boundary
                    self._step_t0 = None
                    self._die(self.error if not self.alive else e)
                    return
                self._step_t0 = None
                if not self.alive:
                    # the watchdog declared this step stuck while it ran;
                    # it could not touch the engine (we held the condition)
                    # so finalize engine-side state now that we are back
                    self._die(self.error)
                    return
                self._publish()
                self._cv.notify_all()

    def _watch_steps(self):
        """Wall-clock watchdog for the step loop: a step running longer
        than ``step_wall_timeout`` is a gray failure (wedged device,
        deadlocked collective) that would hang every stream on this replica
        forever — promote it to a typed replica death.  The stuck step
        HOLDS the engine condition, so the watchdog must not take it:
        it marks the replica dead, fails the outbox directly (pollers fail
        over immediately), and leaves engine-side finalization to the step
        loop whenever the wedged step finally returns."""
        timeout = self.step_wall_timeout
        tick = max(0.01, min(0.25, timeout / 4.0))
        # lock-free reads BY DESIGN: the wedged step owns the cv, so the
        # watchdog must never take it.  _stop/alive are monotonic flags and
        # a stale _step_t0 only delays the trip by one tick.
        while not self._stop and self.alive:  # graftlint: disable=concurrency
            t0 = self._step_t0                # graftlint: disable=concurrency
            if t0 is not None and time.monotonic() - t0 > timeout:
                self._trip_stuck(time.monotonic() - t0)
                return
            time.sleep(tick)

    def _trip_stuck(self, elapsed):
        """Lock-free replica death for a wedged step (see ``_watch_steps``):
        everything ``_die`` does except touching the engine, which stays
        owned by the stuck step thread.  The cv-free error/alive writes are
        the point — taking the cv here would deadlock on the stuck step —
        hence the concurrency pragmas."""
        self.error = StuckStepError(  # graftlint: disable=concurrency
            f"replica {self.name!r} step exceeded step_wall_timeout="
            f"{self.step_wall_timeout}s (ran {elapsed:.2f}s)")
        self.alive = False            # graftlint: disable=concurrency
        _obs.FRONTEND_STUCK_STEPS.inc(replica=self.name)
        if self.router is not None:
            self.router.forget(self.name)
        with self._out_cv:
            for slot in self._out.values():
                if not slot["status"].terminal:
                    slot["status"] = _RequestStatus.FAILED
                    if slot.get("trace") is not None:
                        # recorder lock is a leaf — safe from this cv-free
                        # context; the victim's post-mortem survives ring
                        # churn (and dumps when a dump dir is configured)
                        _flight.pin(slot["trace"], "stuck_step")
            self._out_cv.notify_all()

    def _publish(self):
        """Move every tracked request's new tokens and current status from
        the engine into the outbox and wake pollers.  Caller holds the
        engine condition; terminal slots are already complete and skipped.
        Terminal slots are retained (a drained slot is a status enum and an
        empty list) so re-polls of a finished rid stay answerable — the
        engine keeps its own finished table just the same."""
        eng = self.engine
        with self._out_cv:
            changed = False
            for rid, slot in self._out.items():
                if slot["status"].terminal:
                    continue
                toks = eng.new_tokens(rid)
                status = eng.status(rid)
                if toks:
                    slot["toks"].extend(int(t) for t in toks)
                    changed = True
                if status is not slot["status"]:
                    slot["status"] = status
                    changed = True
            if changed:
                self._out_cv.notify_all()

    def _die(self, error):
        """Step loop died: fail every inflight request with a typed terminal
        status, drop our prefix mirror, and stop accepting work.  Caller
        holds the condition."""
        self.alive = False
        self.error = error
        try:
            self.engine.fail_all(error)
        finally:
            if self.router is not None:
                self.router.forget(self.name)
            self._publish()
            self._cv.notify_all()

    # ---- request facade ------------------------------------------------------
    def load(self):
        """Scheduling pressure: waiting + active requests (the router's
        tie-breaker and the least-loaded fallback metric)."""
        with self._cv:
            eng = self.engine
            return len(eng._waiting) + sum(
                1 for s in eng._slots if s is not None)

    def submit(self, prompt_ids, **kw):
        """Thread-safe ``add_request``; wakes the step loop.  The returned
        rid may already be terminal SHED (engine-level admission)."""
        with self._cv:
            if not self.alive:
                raise ReplicaDeadError(
                    f"replica {self.name!r} is dead: {self.error!r}")
            rid = self.engine.add_request(prompt_ids, **kw)
            ctx = _flight.current()
            with self._out_cv:
                # remember the trace so lock-free anomaly paths (the stuck-
                # step watchdog) can pin it without touching the engine
                self._out[rid] = {"toks": [],
                                  "status": self.engine.status(rid),
                                  "trace": None if ctx is None
                                  else ctx.trace_id}
            self._cv.notify_all()
            return rid

    def poll(self, rid, timeout=None):
        """Block until ``rid`` has new tokens or is terminal; returns
        ``(tokens, status)``.  ``timeout`` bounds the WHOLE wait — the wait
        happens on the outbox condition, which is never held across an
        engine step, so a multi-second step (first-call jit compile, a
        fault-paced slow step) cannot stall a timed poll past its deadline
        and SSE heartbeats keep flowing.  On expiry the current (possibly
        empty) increment is returned with the last published status."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._out_cv:
            while True:
                slot = self._out.get(rid)
                if slot is None:
                    break  # not submitted through this facade
                toks, status = slot["toks"], slot["status"]
                if toks or status.terminal:
                    slot["toks"] = []
                    return toks, status
                if deadline is None:
                    self._out_cv.wait(self._poll)
                else:
                    left = deadline - time.monotonic()
                    if left <= 0:
                        return [], status
                    self._out_cv.wait(min(left, self._poll))
        # fallback for rids the engine was handed directly: read under the
        # engine condition (may block for a step; such callers own the
        # engine's pace anyway)
        with self._cv:
            while True:
                toks = self.engine.new_tokens(rid)
                status = self.engine.status(rid)
                if toks or status.terminal:
                    return toks, status
                if deadline is not None:
                    left = deadline - time.monotonic()
                    if left <= 0:
                        return [], status
                    self._cv.wait(min(left, self._poll))
                else:
                    self._cv.wait(self._poll)

    def cancel(self, rid):
        with self._cv:
            ok = self.engine.cancel(rid)
            self._publish()
            self._cv.notify_all()
            return ok

    def status(self, rid):
        with self._cv:
            return self.engine.status(rid)

    def result(self, rid):
        with self._cv:
            return list(self.engine.result(rid))

    def request_error(self, rid):
        with self._cv:
            return self.engine.error(rid)

    def ttft(self, rid):
        with self._cv:
            try:
                return self.engine.ttft(rid)
            except KeyError:
                return None

    def tpot(self, rid):
        with self._cv:
            try:
                return self.engine.tpot(rid)
            except KeyError:
                return None

    def prefix_keys(self):
        """Chain keys resident in this replica's prefix cache — the fleet
        layer snapshots these over RPC to warm the gateway-side router for
        replicas whose cache events never cross the process boundary."""
        with self._cv:
            fn = getattr(self.engine, "prefix_keys", None)
            return list(fn()) if fn is not None else []

    def export_pages(self, keys):
        """Serve a peer's page pull: the longest prefix of ``keys`` this
        replica's engine holds in any KV tier, as a dense host block (None
        on a full miss or an engine without the tier API)."""
        with self._cv:
            if not self.alive:
                raise ReplicaDeadError(
                    f"replica {self.name!r} is dead: {self.error!r}")
            fn = getattr(self.engine, "export_pages", None)
            return fn(keys) if fn is not None else None

    def import_pages(self, payload):
        """Splice a peer's exported page block into this replica's engine
        (0 when the engine lacks the tier API)."""
        with self._cv:
            if not self.alive:
                raise ReplicaDeadError(
                    f"replica {self.name!r} is dead: {self.error!r}")
            fn = getattr(self.engine, "import_pages", None)
            return fn(payload) if fn is not None else 0

    def health(self):
        with self._cv:
            h = self.engine.health()
            # read alive/error under the cv too: the snapshot then can't
            # pair a pre-death engine view with a post-death error
            h["alive"] = self.alive
            h["error"] = repr(self.error) if self.error is not None else None
        h["replica"] = self.name
        return h

    def metrics(self):
        with self._cv:
            return self.engine.metrics()


class RequestHandle:
    """Where a routed request lives: the replica, its rid there, and the
    submit timestamp the stream-duration histogram measures from.

    For crash recovery the handle also remembers what was submitted
    (``prompt_ids`` / ``kw``) and every token already delivered to the
    caller (``emitted`` — ``streamed`` is its length).  A replica death
    with ``streamed == 0`` may be transparently resubmitted elsewhere
    (``requeued``, once); one that already streamed tokens may be RESUMED
    once (``resumed``) — resubmitted with ``emitted`` as re-prefill
    context so the continuation is token-exact.  Only when recovery itself
    fails does the handle pin a typed terminal via ``final_status`` /
    ``final_error``.  ``resume_t0`` stamps the death-detection instant so
    the first post-resume token lands in the splice-latency histogram."""

    __slots__ = ("replica", "rid", "t0", "_accounted", "prompt_ids", "kw",
                 "emitted", "requeued", "resumed", "resume_t0",
                 "final_status", "final_error", "trace_id")

    def __init__(self, replica, rid, prompt_ids=None, kw=None):
        self.replica = replica
        self.rid = rid
        self.trace_id = None         # flight-recorder trace (ambient ctx)
        self.t0 = time.perf_counter()
        self._accounted = False
        self.prompt_ids = prompt_ids
        self.kw = kw or {}
        self.emitted = []
        self.requeued = False
        self.resumed = False
        self.resume_t0 = None
        self.final_status = None
        self.final_error = None

    @property
    def streamed(self):
        """Tokens already delivered to the caller."""
        return len(self.emitted)

    def __repr__(self):
        return f"RequestHandle({self.replica.name!r}, rid={self.rid})"


class ReplicaSet:
    """N replicas behind one submit/stream/cancel facade.

    ``engines`` may be constructed engines or a list of (name, engine)
    pairs; default names are ``r0..rN-1``.  The default router is
    :class:`~.router.PrefixAffinityRouter` fed by every replica's cache
    events; pass ``router=RoundRobinRouter()`` for the affinity-blind
    baseline.  ``admission`` is consulted before routing — a refusal raises
    :class:`~.admission.ShedError` without touching any replica.

    ``requeue=True`` turns on crash recovery: when a replica dies under an
    inflight request that has streamed ZERO tokens, the request is
    transparently resubmitted once onto a surviving replica (routed warm
    through the prefix-affinity router).  A request that already streamed
    tokens is RESUMED once instead: resubmitted with its emitted history as
    ``resume_tokens`` — the survivor re-prefills prompt + history (cheap
    when prefix-cache pages are warm) and continues decode token-exact, so
    the caller's stream splices seamlessly with no duplicated or dropped
    tokens.  A partially-streamed request fails typed FAILED only when its
    single resume attempt also dies.  The multi-process fleet enables this —
    the in-process default stays off, preserving fail-fast semantics.
    """

    def __init__(self, engines, router=None, admission=None, names=None,
                 start=True, poll_interval=0.05, requeue=False,
                 step_wall_timeout=None, peer_pull=False,
                 peer_pull_min_pages=1):
        engines = list(engines)
        if not engines:
            raise ValueError("ReplicaSet needs at least one engine")
        if engines and isinstance(engines[0], tuple):
            names = [n for n, _ in engines]
            engines = [e for _, e in engines]
        if names is None:
            names = [f"r{i}" for i in range(len(engines))]
        if router is None:
            router = PrefixAffinityRouter(page_size=engines[0].page)
        self.router = router
        self.admission = admission if admission is not None else AlwaysAdmit()
        self.requeue = bool(requeue)
        # peer KV tier: when routing passes over a deeper-overlap holder
        # (router max_load_skew), cold-pull its page chain into the chosen
        # replica before submit.  Off by default — the pull is pure warmth,
        # never correctness, and extra RPCs would perturb seeded chaos
        # schedules that count rpc.* fault ordinals.
        self._peer_pull = bool(peer_pull)
        self._peer_pull_min = int(peer_pull_min_pages)
        self._pull_retry = RetryPolicy(max_attempts=3, base_delay=0.01,
                                       max_delay=0.25)
        self.replicas = [
            EngineReplica(n, e, router=router, poll_interval=poll_interval,
                          step_wall_timeout=step_wall_timeout)
            for n, e in zip(names, engines)]
        self._by_name = {r.name: r for r in self.replicas}
        if start:
            self.start()

    # ---- lifecycle -----------------------------------------------------------
    def start(self):
        for r in self.replicas:
            r.start()
        return self

    def close(self):
        for r in self.replicas:
            r.close()

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.close()

    def replica(self, name):
        return self._by_name[name]

    def alive_replicas(self):
        return [r for r in self.replicas if r.alive]

    def add_replica(self, replica, start=False):
        """Join a pre-built replica (in-process or remote) into routing;
        replaces any previous replica of the same name."""
        old = self._by_name.get(replica.name)
        if old is not None:
            self.remove_replica(old.name)
        self.replicas.append(replica)
        self._by_name[replica.name] = replica
        if start and hasattr(replica, "start"):
            replica.start()
        return replica

    def remove_replica(self, name):
        """Drop a replica from routing (its inflight handles hit the death
        path on their next poll); returns the removed replica or None."""
        rep = self._by_name.pop(name, None)
        if rep is not None:
            self.replicas.remove(rep)
            self.router.forget(name)
        return rep

    # ---- request facade ------------------------------------------------------
    def submit(self, prompt_ids, **kw):
        """Admit, route, and submit one request; returns a
        :class:`RequestHandle`.  Raises :class:`~.admission.ShedError` on
        admission refusal and :class:`ReplicaDeadError` with no live
        replicas."""
        _faults.FAULTS.maybe_fire("frontend.route")
        alive = self.alive_replicas()
        if not alive:
            raise ReplicaDeadError("no live replicas")
        decision = self.admission.decide(alive)
        if not decision.admit:
            _obs.FRONTEND_SHED.inc(reason=decision.reason)
            _obs.FRONTEND_REQUESTS.inc(outcome="shed")
            raise ShedError(decision.reason, decision.retry_after)
        # a replica can die between routing and submit (remote worker
        # killed); reroute over the survivors instead of failing the request
        tried = set()
        while True:
            candidates = [r for r in self.alive_replicas()
                          if r.name not in tried]
            if not candidates:
                raise ReplicaDeadError("no live replicas")
            route = self.router.route(prompt_ids, candidates)
            rep = route.replica
            if self._peer_pull and route.holder is not None \
                    and route.holder is not rep \
                    and route.holder_overlap - route.overlap \
                    >= self._peer_pull_min:
                # warm the chosen replica with the passed-over holder's
                # pages BEFORE submit, so admission sees them as hits
                self._peer_warm(rep, route.holder, prompt_ids,
                                route.overlap, route.holder_overlap)
            _faults.FAULTS.maybe_fire("frontend.submit", replica=rep.name)
            try:
                rid = rep.submit(prompt_ids, **kw)
                break
            except ReplicaDeadError:
                tried.add(rep.name)
        if rep.status(rid) is _RequestStatus.SHED:
            # the engine's own admission control refused it (queue bound /
            # page watermark); surface it exactly like a frontend shed
            _obs.FRONTEND_SHED.inc(reason="engine")
            _obs.FRONTEND_REQUESTS.inc(outcome="shed")
            raise ShedError("engine", decision.retry_after)
        _obs.FRONTEND_ROUTED.inc(replica=rep.name, reason=route.reason)
        _obs.FRONTEND_INFLIGHT.inc()
        handle = RequestHandle(rep, rid, prompt_ids=list(prompt_ids),
                               kw=dict(kw))
        ctx = _flight.current()
        if ctx is not None:
            handle.trace_id = ctx.trace_id
            _flight.record("routed", rid=rid, trace_id=ctx.trace_id,
                           replica=rep.name, reason=route.reason)
        return handle

    def _peer_warm(self, rep, holder, prompt_ids, lo, hi):
        """Cold-pull the passed-over holder's cached page chain
        ``[lo, hi)`` into the chosen replica before submit — the peer tier
        of the KV hierarchy.  Strictly best-effort: a miss (the holder aged
        the chain out), a dead peer, or a ``kv.peer_pull`` fault all fall
        back to recompute; the request is submitted regardless and its
        tokens are identical either way — only prefill work changes."""
        page = getattr(self.router, "page", None)
        if page is None:
            return
        keys = prefix_page_keys(prompt_ids, page)[lo:hi]
        if not keys:
            return

        def attempt():
            try:
                _faults.FAULTS.maybe_fire(
                    "kv.peer_pull", replica=rep.name, holder=holder.name)
                return holder.export_pages(keys)
            except Exception as err:
                if getattr(err, "transient", False):
                    raise _TransientPull(err) from err
                raise

        try:
            payload = retry_call(attempt, policy=self._pull_retry,
                                 retry_on=(_TransientPull,),
                                 op="kv.peer_pull")
            n = rep.import_pages(payload) if payload else 0
        except Exception:  # noqa: BLE001 — recompute fallback
            _obs.FRONTEND_PEER_PULLS.inc(outcome="failed")
            return
        _obs.FRONTEND_PEER_PULLS.inc(outcome="ok" if n else "miss")

    def _account(self, handle, status):
        """First terminal observation of a request: outcome counter, inflight
        gauge, stream-duration histogram, and the admission policy's TTFT and
        TPOT windows.  Idempotent per handle."""
        if handle._accounted:
            return
        handle._accounted = True
        _obs.FRONTEND_REQUESTS.inc(outcome=status.value)
        _obs.FRONTEND_INFLIGHT.inc(-1)
        _obs.FRONTEND_STREAM_SECONDS.observe(time.perf_counter() - handle.t0)
        try:
            self.admission.observe_ttft(handle.replica.ttft(handle.rid))
            observe_tpot = getattr(self.admission, "observe_tpot", None)
            if observe_tpot is not None:
                observe_tpot(handle.replica.tpot(handle.rid))
        except ReplicaDeadError:
            pass  # the replica died under us; its latencies died with it

    # ---- replica-death handling ---------------------------------------------
    def _poll_handle(self, handle, timeout):
        """``replica.poll`` with fleet-level crash recovery: a dead replica
        requeues the handle (zero tokens streamed), resumes it with its
        emitted history (partially streamed), or — when recovery itself is
        impossible — pins a typed FAILED terminal on it."""
        if handle.final_status is not None:
            return [], handle.final_status
        try:
            toks, status = handle.replica.poll(handle.rid, timeout=timeout)
        except ReplicaDeadError as e:
            return [], self._on_replica_death(handle, e)
        if (status is _RequestStatus.FAILED and self.requeue
                and not getattr(handle.replica, "alive", True)):
            # in-process replica death: the step loop's fail_all pinned
            # FAILED instead of raising on poll.  Tokens the dying step
            # decoded but never delivered are dropped here — the resume
            # regenerates them (greedy/fixed-seed tokens are pure functions
            # of context), so the caller's stream stays gap-free.
            return [], self._on_replica_death(handle, ReplicaDeadError(
                f"replica {handle.replica.name!r} died mid-request: "
                f"{handle.replica.error!r}"))
        handle.emitted.extend(int(t) for t in toks)
        if toks and handle.resume_t0 is not None:
            _obs.FRONTEND_SPLICE_SECONDS.observe(
                time.perf_counter() - handle.resume_t0)
            handle.resume_t0 = None
        return toks, status

    def _on_replica_death(self, handle, error):
        """The replica under ``handle`` died (lease expiry / RPC failure /
        in-process step death).  Zero-streamed requests are requeued once;
        partially-streamed ones are resumed once with their emitted history
        as re-prefill context (token-exact continuation).  Returns the
        handle's new status: a live one after successful recovery, else the
        pinned terminal."""
        if self.requeue and handle.prompt_ids is not None:
            if handle.streamed == 0 and not handle.requeued:
                try:
                    alive = [r for r in self.alive_replicas()
                             if r is not handle.replica]
                    if alive:
                        route = self.router.route(handle.prompt_ids, alive)
                        # resubmit under the original trace so the survivor's
                        # engine spans join the caller's request timeline
                        rctx = (None if handle.trace_id is None
                                else _flight.mint(handle.trace_id))
                        with _flight.use_context(rctx):
                            rid = route.replica.submit(handle.prompt_ids,
                                                       **handle.kw)
                        if route.replica.status(rid) \
                                is not _RequestStatus.SHED:
                            handle.replica, handle.rid = route.replica, rid
                            handle.requeued = True
                            if handle.trace_id is not None:
                                _flight.record("requeue", rid=rid,
                                               trace_id=handle.trace_id,
                                               replica=route.replica.name)
                            _obs.FRONTEND_REQUEUED.inc()
                            _obs.FRONTEND_ROUTED.inc(
                                replica=route.replica.name, reason="requeue")
                            return route.replica.status(rid)
                except (ReplicaDeadError, ShedError):
                    pass  # no survivor could take it: fall through to FAILED
            elif handle.streamed > 0 and not handle.resumed:
                status = self._resume(handle)
                if status is not None:
                    return status
        handle.final_status = _RequestStatus.FAILED
        handle.final_error = error
        self._account(handle, _RequestStatus.FAILED)
        return _RequestStatus.FAILED

    def _resume(self, handle):
        """One attempt to continue a partially-streamed ``handle`` on a
        survivor: resubmit with ``emitted`` as ``resume_tokens`` (the
        engine re-prefills prompt + history, cheap when prefix-cache pages
        are warm) and the REMAINING token budget.  Returns the resumed
        request's live status, a locally-pinned terminal when the dead
        replica owed nothing but the final status, or None when the attempt
        failed (the caller pins FAILED)."""
        handle.resumed = True
        t_death = time.perf_counter()
        emitted = list(handle.emitted)
        kw = dict(handle.kw)
        remaining = int(kw.get("max_new_tokens", 16)) - len(emitted)
        eos = kw.get("eos_token_id")
        hit_eos = eos is not None and emitted[-1] == eos
        if remaining <= 0 or hit_eos:
            # the caller already holds the complete output; only the
            # terminal status died with the replica — pin it locally
            status = (_RequestStatus.EOS if hit_eos
                      else _RequestStatus.FINISHED)
            handle.final_status = status
            self._account(handle, status)
            return status
        kw["max_new_tokens"] = remaining
        # a request already driven with resume_tokens (gateway crash
        # recovery) must carry its FULL history — prior resume prefix plus
        # what this incarnation streamed — or the re-prefill would forget
        # the pre-recovery tokens
        kw["resume_tokens"] = list(kw.get("resume_tokens") or []) + emitted
        try:
            _faults.FAULTS.maybe_fire("frontend.resume",
                                      replica=handle.replica.name)
            alive = [r for r in self.alive_replicas()
                     if r is not handle.replica]
            if not alive:
                return None
            # route by prompt + history: the survivor holding the warmest
            # prefix pages re-prefills the least
            route = self.router.route(list(handle.prompt_ids) + emitted,
                                      alive)
            # the resumed incarnation stays on the ORIGINAL trace — one
            # merged timeline shows death, splice, and continuation
            rctx = (None if handle.trace_id is None
                    else _flight.mint(handle.trace_id))
            with _flight.use_context(rctx):
                rid = route.replica.submit(handle.prompt_ids, **kw)
            if route.replica.status(rid) is _RequestStatus.SHED:
                return None
        except (ReplicaDeadError, ShedError, _faults.InjectedFault):
            return None  # the resume attempt itself died: caller pins FAILED
        handle.replica, handle.rid = route.replica, rid
        handle.resume_t0 = t_death
        if handle.trace_id is not None:
            _flight.record("resume", rid=rid, trace_id=handle.trace_id,
                           replica=route.replica.name,
                           streamed=len(emitted))
            _flight.pin(handle.trace_id, "resume")
        _obs.FRONTEND_RESUMED.inc()
        _obs.FRONTEND_ROUTED.inc(replica=route.replica.name, reason="resume")
        return route.replica.status(rid)

    def stream_batches(self, handle, poll_timeout=0.5, heartbeat=None):
        """Yield ``(tokens, status)`` batches for ``handle`` — each batch
        exactly as one poll delivered it — until the request is terminal.
        This is the primitive the durable request plane journals from: a
        batch boundary here is a journal-record boundary there.

        ``heartbeat`` (seconds): when set, an EMPTY batch ``([], status)``
        is yielded whenever that long passes without a token — the liveness
        signal :meth:`stream` turns into its ``None`` pings."""
        last = time.monotonic()
        slice_ = (poll_timeout if heartbeat is None
                  else min(poll_timeout, float(heartbeat)))
        while True:
            toks, status = self._poll_handle(handle, slice_)
            if toks:
                yield list(toks), status
                last = time.monotonic()
            elif (heartbeat is not None and not status.terminal
                    and time.monotonic() - last >= float(heartbeat)):
                yield [], status
                last = time.monotonic()
            if status.terminal and not toks:
                # drain once more: tokens emitted by the finalizing step
                # land before the terminal status is visible.  The terminal
                # status is already in hand, so a replica dying exactly here
                # has nothing left to deliver — never trigger recovery (a
                # resume now could regenerate a completed request).
                if handle.final_status is None:
                    try:
                        tail, _ = handle.replica.poll(handle.rid, timeout=0)
                    except ReplicaDeadError:
                        tail = []
                    handle.emitted.extend(int(t) for t in tail)
                    if tail:
                        yield list(tail), status
                self._account(handle, status)
                return

    def stream(self, handle, poll_timeout=0.5, heartbeat=None):
        """Yield ``handle``'s tokens as they are emitted, one int at a time,
        until the request is terminal.  Check ``self.status(handle)`` after
        exhaustion for the terminal status.

        ``heartbeat`` (seconds): when set, the generator yields ``None``
        whenever that long passes without a token — long prefill or queue
        waits stay observably alive.  The SSE gateway turns each ``None``
        into a ``: ping`` keep-alive comment, whose failing write is also
        how a client that disconnected before the first token is detected.
        """
        for toks, _status in self.stream_batches(handle, poll_timeout,
                                                 heartbeat):
            if not toks:
                yield None
            else:
                yield from toks

    def result(self, handle, timeout=None):
        """Block until terminal; returns ``(tokens, status)``."""
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            _, status = self._poll_handle(handle, 1.0)
            if status.terminal:
                self._account(handle, status)
                if handle.final_status is _RequestStatus.FAILED:
                    return [], handle.final_status
                if handle.final_status is not None or handle.resumed:
                    # locally-pinned terminal, or a resumed request whose
                    # replica-side result holds only the post-splice tail:
                    # ``emitted`` is the complete drained stream
                    return list(handle.emitted), status
                return handle.replica.result(handle.rid), status
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(f"{handle!r} not terminal after {timeout}s")

    def status(self, handle):
        if handle.final_status is not None:
            return handle.final_status
        try:
            return handle.replica.status(handle.rid)
        except ReplicaDeadError as e:
            return self._on_replica_death(handle, e)

    def cancel(self, handle):
        if handle.final_status is not None:
            return False
        try:
            return handle.replica.cancel(handle.rid)
        except ReplicaDeadError:
            return False

    def request_error(self, handle):
        if handle.final_error is not None:
            return repr(handle.final_error)
        try:
            return handle.replica.request_error(handle.rid)
        except ReplicaDeadError as e:
            return repr(e)

    def health(self):
        """Per-replica health snapshots keyed by replica name."""
        return {r.name: r.health() for r in self.replicas}

    def metrics(self):
        """Per-replica registry snapshots keyed by replica name."""
        return {r.name: r.metrics() for r in self.replicas}

    # ---- fleet observability -------------------------------------------------
    def _federation_members(self, attr):
        """``(name, bound scrape method)`` for every live member that runs
        in its OWN process and exposes ``attr`` (in-process replicas share
        this registry/recorder and contribute through the local snapshot).
        Members already known dead are skipped WITHOUT touching the error
        counter — their failure was counted once, when it was detected, and
        re-counting per /metrics scrape would turn the counter's rate into
        a dead-member clock — tallied instead in the
        ``frontend_federation_skipped`` gauge."""
        members, skipped = [], 0
        for rep in list(self.replicas):
            fn = getattr(rep, attr, None)
            if fn is None:
                continue  # in-process: already in the local snapshot
            if not getattr(rep, "alive", True):
                skipped += 1
                continue
            members.append((rep.name, fn))
        _obs.FRONTEND_FEDERATION_SKIPPED.set(skipped)
        return members

    @staticmethod
    def _scrape_fleet(jobs):
        """Run per-member scrape thunks CONCURRENTLY so the page's worst
        case is ~one deadline, not one deadline per member, and return
        {name: result} for the members that answered.  A thunk that raises
        (dead mid-scrape, wedged past its deadline) is dropped with
        ``frontend_federation_errors_total{replica=}`` incremented — a
        half-dead worker must never wedge the /metrics page."""
        if not jobs:
            return {}
        results = {}
        with ThreadPoolExecutor(max_workers=min(16, len(jobs)),
                                thread_name_prefix="fed-scrape") as pool:
            futures = {pool.submit(fn): name for name, fn in jobs.items()}
            for fut in as_completed(futures):
                name = futures[fut]
                try:
                    results[name] = fut.result()
                except Exception:  # noqa: BLE001 — scrape must never wedge
                    _obs.FRONTEND_FEDERATION_ERRORS.inc(replica=name)
        return results

    def federated_snapshot(self, deadline=1.0):
        """Full registry snapshots of every live own-process member (remote
        workers), keyed by replica name — the scrape half of metrics
        federation.  Dead-member and failure semantics per
        :meth:`_federation_members` / :meth:`_scrape_fleet`."""
        return self._scrape_fleet({
            name: functools.partial(fn, deadline=deadline)
            for name, fn in self._federation_members("metrics_snapshot")})

    def metrics_exposition(self, deadline=1.0):
        """One Prometheus page for the WHOLE fleet: this process's registry
        merged with every live remote member's snapshot, remote series
        relabeled ``replica=<name>``."""
        # scrape the remotes FIRST: a member that dies mid-scrape bumps the
        # federation error counter, and the local snapshot must be taken
        # after that so the very page that skipped it reports the skip
        remotes = self.federated_snapshot(deadline)
        return _obs.render_snapshot(_obs.merge_snapshots(
            _obs.REGISTRY.snapshot(), remotes))

    def trace_events_fleet(self, trace_id, deadline=1.0):
        """Every span event recorded for ``trace_id`` anywhere in the
        fleet — this process's flight recorder plus each live remote
        member's — merged, deduplicated, and causally ordered.  Dead or
        unresponsive members are skipped (same semantics as the metrics
        scrape)."""
        pulled = self._scrape_fleet({
            name: functools.partial(fn, trace_id, deadline=deadline)
            for name, fn in self._federation_members("trace_events")})
        return _flight.merge_events(_flight.snapshot_events(trace_id),
                                    *pulled.values())
