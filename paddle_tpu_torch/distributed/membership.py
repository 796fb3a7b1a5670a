"""Lease-based membership over :class:`~paddle_tpu_torch.distributed.store.TCPStore`.

etcd-style membership for the serving fleet, built from the store's own
primitives instead of a new service: a member ``register()``s under a TTL
lease and an ADD-derived **epoch** (monotonic across restarts of the same
name — a respawned worker is a *new* incarnation, never confused with its
dead predecessor), a heartbeat thread renews the lease through
:class:`~paddle_tpu_torch.core.retry.RetryPolicy`, and any number of watchers
diff the membership view into typed ``join`` / ``leave`` / ``expire``
events.

Store layout (all under ``ms/<group>/``)::

    ms/<group>/index          pickled sorted list of member names; every
                              mutation is a raw-bytes compare_and_set loop,
                              so concurrent joins/leaves never lose updates
    ms/<group>/epoch/<name>   ADD counter — the epoch source
    ms/<group>/m/<name>       pickled member record {name, epoch, meta,
                              expires_at}

Clocks: ``expires_at`` is an absolute reading of the injectable ``clock``
(default ``time.monotonic`` — CLOCK_MONOTONIC, shared by every process on
one host).  Tests inject one fake clock into the service on both sides and
drive expiry by advancing it; multi-host deployments must supply a
host-comparable clock (e.g. ``time.time`` under NTP).

Failure semantics: a member that stops renewing (crash, wedge, kill -9)
keeps its record in the store until a watcher's :meth:`MembershipWatcher.poll`
observes ``expires_at`` in the past — the watcher then emits ``expire``,
reaps the record, and bumps ``membership_lease_expiries_total``.  A clean
:meth:`Lease.release` deletes the record immediately (``leave``); the store's
typed deleted-miss keeps concurrent readers from stalling on the vanished
key.

Fault points (:mod:`paddle_tpu_torch.testing.faults`): ``membership.register``
fires inside registration, ``membership.heartbeat`` inside every renewal
attempt — chaos tests starve a lease to death with ``Always`` or exercise
the retry path with ``FailNth``.
"""
from __future__ import annotations

import pickle
import threading
import time

from .. import observability as _obs
from ..core.retry import RetryError, RetryPolicy, retry_call
from ..testing.faults import FAULTS as _faults
from ..testing.faults import InjectedFault as _InjectedFault
from .store import StoreKeyDeleted

__all__ = ["MemberInfo", "MembershipEvent", "Lease", "LeaseLostError",
           "MembershipService", "MembershipWatcher",
           "JOIN", "LEAVE", "EXPIRE"]

JOIN, LEAVE, EXPIRE = "join", "leave", "expire"

# store errors any single membership op may transiently hit
_STORE_ERRORS = (OSError, ConnectionError, TimeoutError, _InjectedFault)


class LeaseLostError(RuntimeError):
    """The heartbeat could not renew the lease before it ran out of
    retries — the member must assume the fleet has expired it."""


class MemberInfo:
    """One member's registered state as read from the store."""

    __slots__ = ("name", "epoch", "meta", "expires_at")

    def __init__(self, name, epoch, meta, expires_at):
        self.name = name
        self.epoch = int(epoch)
        self.meta = meta
        self.expires_at = float(expires_at)

    def __repr__(self):
        return (f"MemberInfo({self.name!r}, epoch={self.epoch}, "
                f"expires_at={self.expires_at:.3f})")


class MembershipEvent:
    """One typed membership transition: ``kind`` is ``join`` (new name or
    new epoch of a known name), ``leave`` (record cleanly gone), or
    ``expire`` (lease TTL lapsed without renewal)."""

    __slots__ = ("kind", "member")

    def __init__(self, kind, member):
        self.kind = kind
        self.member = member

    def __repr__(self):
        return f"MembershipEvent({self.kind}, {self.member!r})"


class MembershipService:
    """Shared view of one membership group over one store client.

    Thread-safe for the operations one process performs (register + its
    lease heartbeats + watcher polls): the store client serializes on its
    own socket lock and index mutations are CAS loops.
    """

    def __init__(self, store, group="fleet", ttl=2.0, clock=time.monotonic,
                 retry_policy=None):
        if float(ttl) <= 0:
            raise ValueError("ttl must be > 0")
        self.store = store
        self.group = str(group)
        self.ttl = float(ttl)
        self.clock = clock
        self.retry_policy = retry_policy or RetryPolicy(
            max_attempts=5, base_delay=0.02, max_delay=0.25)

    # ---- key layout ----------------------------------------------------------
    def _k_index(self):
        return f"ms/{self.group}/index"

    def _k_epoch(self, name):
        return f"ms/{self.group}/epoch/{name}"

    def _k_member(self, name):
        return f"ms/{self.group}/m/{name}"

    # ---- registration / records ----------------------------------------------
    def register(self, name, meta=None):
        """Join the group: allocate the next epoch for ``name``, write the
        lease record, and add the name to the index.  Returns the
        :class:`Lease` whose heartbeat keeps the membership alive."""
        name = str(name)
        _faults.maybe_fire("membership.register", group=self.group,
                           member=name)
        epoch = int(self.store.add(self._k_epoch(name), 1))
        expires_at = self._write_record(name, epoch, meta)
        self._index_update(lambda names: names | {name})
        return Lease(self, name, epoch, meta, expires_at)

    def _write_record(self, name, epoch, meta):
        expires_at = float(self.clock()) + self.ttl
        self.store.set(self._k_member(name), {
            "name": name, "epoch": epoch, "meta": meta,
            "expires_at": expires_at})
        return expires_at

    def _remove_member(self, name):
        """Best-effort reap of one member's record + index entry (release
        and watcher-expiry share this)."""
        try:
            self.store.delete_key(self._k_member(name))
        finally:
            self._index_update(lambda names: names - {name})

    def evict(self, name):
        """Administratively remove ``name`` from the group NOW — watchers
        observe ``leave`` on their next poll instead of waiting out the TTL.
        This is the third-party counterpart of :meth:`Lease.release` for
        members that cannot release themselves: the supervisor evicts a
        quarantined crash-looper so routers stop selecting it immediately.
        Idempotent; a concurrent release/expiry of the same name is
        harmless (both paths reap the same record)."""
        self._remove_member(str(name))

    def _index_update(self, mutate):
        """Raw-bytes CAS loop over the index key — lost updates are
        impossible, concurrent mutators just retry on the fresh bytes."""
        while True:
            try:
                raw = self.store.get_raw(self._k_index(), timeout=0.05)
            except (TimeoutError, StoreKeyDeleted):
                raw = None
            names = set(pickle.loads(raw)) if raw else set()
            new = mutate(set(names))
            if new == names:
                return
            swapped, _ = self.store.compare_and_set(
                self._k_index(), raw, sorted(new))
            if swapped:
                return

    # ---- read side -----------------------------------------------------------
    def members(self):
        """Every member with a readable record, keyed by name — including
        ones already past expiry (the watcher decides their fate).  A name
        in the index whose record is gone (release in flight, or a crashed
        pre-record registration) is skipped."""
        try:
            names = self.store.get(self._k_index(), timeout=0.05)
        except (TimeoutError, StoreKeyDeleted):
            return {}
        out = {}
        for name in names:
            try:
                rec = self.store.get(self._k_member(name), timeout=0.05)
            except (TimeoutError, StoreKeyDeleted):
                continue
            out[name] = MemberInfo(rec["name"], rec["epoch"], rec["meta"],
                                   rec["expires_at"])
        return out

    def watch(self):
        """A fresh :class:`MembershipWatcher` over this group (its first
        :meth:`~MembershipWatcher.poll` reports every live member as a
        ``join``)."""
        return MembershipWatcher(self)


class Lease:
    """A member's live claim on its name: renew it, release it, or let the
    heartbeat thread do the renewing until :meth:`stop_heartbeat`."""

    def __init__(self, service, name, epoch, meta, expires_at):
        self.service = service
        self.name = name
        self.epoch = int(epoch)
        self.meta = meta
        self.expires_at = float(expires_at)
        self.lost = False
        self.released = False
        self._hb_stop = threading.Event()
        self._hb_thread = None
        self._on_lost = None

    # ---- renewal -------------------------------------------------------------
    def renew(self):
        """One lease renewal through the service's retry policy; raises
        :class:`LeaseLostError` when every attempt fails.  Latency lands in
        ``membership_heartbeat_seconds``."""
        svc = self.service
        t0 = time.perf_counter()

        def attempt():
            _faults.maybe_fire("membership.heartbeat", group=svc.group,
                               member=self.name)
            return svc._write_record(self.name, self.epoch, self.meta)

        try:
            self.expires_at = retry_call(
                attempt, policy=svc.retry_policy, retry_on=_STORE_ERRORS,
                op="membership.heartbeat")
        except RetryError as e:
            self.lost = True
            raise LeaseLostError(
                f"lease {self.name!r} (epoch {self.epoch}) could not renew: "
                f"{e}") from e
        _obs.MEMBERSHIP_HEARTBEAT_SECONDS.observe(
            time.perf_counter() - t0, group=svc.group)
        return self.expires_at

    def start_heartbeat(self, interval=None, on_lost=None):
        """Renew every ``interval`` seconds (default ``ttl / 3``) from a
        named daemon thread until :meth:`stop_heartbeat` / :meth:`release`.
        A renewal that exhausts its retries marks the lease ``lost``, calls
        ``on_lost(error)`` once, and stops the thread — the owner decides
        whether to exit or re-register."""
        if self._hb_thread is not None:
            return self
        self._on_lost = on_lost
        self._hb_interval = (self.service.ttl / 3.0 if interval is None
                             else float(interval))
        self._hb_stop.clear()
        self._hb_thread = threading.Thread(
            target=self._hb_loop, name=f"lease-hb-{self.name}", daemon=True)
        self._hb_thread.start()
        return self

    def _hb_loop(self):
        while not self._hb_stop.wait(self._hb_interval):
            try:
                self.renew()
            except LeaseLostError as e:
                if self._on_lost is not None:
                    self._on_lost(e)
                return

    def stop_heartbeat(self):
        self._hb_stop.set()
        if self._hb_thread is not None:
            self._hb_thread.join(timeout=10.0)
            self._hb_thread = None

    # ---- teardown ------------------------------------------------------------
    def release(self):
        """Graceful leave: stop the heartbeat and delete the record so
        watchers see ``leave`` immediately (no TTL wait).  Idempotent."""
        self.stop_heartbeat()
        if self.released:
            return
        self.released = True
        self.service._remove_member(self.name)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.release()


class MembershipWatcher:
    """Diffs successive membership snapshots into typed events.

    :meth:`poll` is the deterministic unit tests and the fleet's sync loop
    call directly; :meth:`start` wraps it in a background thread for
    wall-clock deployments.  Expired members are REAPED by the watcher (the
    record and index entry are deleted) so one watcher cleaning up is
    enough and ``members()`` converges for everyone.
    """

    def __init__(self, service):
        self.service = service
        self._last = {}          # name -> MemberInfo of live members
        self._thread = None
        self._stop = threading.Event()

    def poll(self):
        """One membership diff; returns the (possibly empty) event list in
        deterministic name order: expires, then leaves, then joins."""
        svc = self.service
        now = float(svc.clock())
        current = svc.members()
        events = []
        live = {}
        for name in sorted(current):
            info = current[name]
            if info.expires_at <= now:
                prev = self._last.get(name)
                # an expired record we never saw alive still expires — the
                # member died before any watcher observed it
                events.append(MembershipEvent(EXPIRE, info))
                _obs.MEMBERSHIP_LEASE_EXPIRIES.inc(group=svc.group)
                svc._remove_member(name)
                if prev is not None and prev.epoch != info.epoch:
                    pass  # the newer epoch already superseded what we knew
            else:
                live[name] = info
        for name in sorted(self._last):
            if name not in current:
                events.append(MembershipEvent(LEAVE, self._last[name]))
        for name in sorted(live):
            prev = self._last.get(name)
            if prev is None or prev.epoch != live[name].epoch:
                events.append(MembershipEvent(JOIN, live[name]))
        self._last = live
        for ev in events:
            _obs.MEMBERSHIP_EVENTS.inc(group=svc.group, kind=ev.kind)
        return events

    def members(self):
        """The watcher's current view of live members (last poll)."""
        return dict(self._last)

    # ---- background loop -----------------------------------------------------
    def start(self, interval=0.5, on_event=None):
        """Poll every ``interval`` seconds from a daemon thread, feeding
        each event to ``on_event``; :meth:`stop` joins the thread."""
        if self._thread is not None:
            return self
        self._stop.clear()

        def loop():
            while not self._stop.wait(interval):
                try:
                    events = self.poll()
                except _STORE_ERRORS:
                    continue  # store hiccup: next tick retries the diff
                if on_event is not None:
                    for ev in events:
                        on_event(ev)

        self._thread = threading.Thread(
            target=loop, name=f"membership-watch-{self.service.group}",
            daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None
