"""Multi-process fleet: membership-driven routing over remote workers.

The in-process :class:`~.replica.ReplicaSet` discovers replica death by
sharing an address space; the fleet cannot, so it listens to the
:mod:`~paddle_tpu_torch.distributed.membership` plane instead.
:class:`FleetReplicaSet` keeps the whole ReplicaSet facade (submit /
stream / result / cancel / health — the gateway is unchanged) but its
replica list is a **fold over membership events**:

- ``join``  → build a :class:`RemoteReplica` from the member's advertised
  ``host``/``port`` meta and warm the prefix-affinity router with the
  worker's resident cache keys (``prefix_keys`` RPC) — a respawned worker
  (same name, new epoch) transparently replaces its dead incarnation.
- ``leave`` → clean drain: drop from routing (inflight work finished
  before the worker released its lease).
- ``expire`` → the worker stopped heartbeating (crash / wedge / kill -9):
  mark the replica dead so every inflight poll takes the crash-recovery
  path, then drop it from routing.

Crash recovery itself lives in the base class (``requeue=True`` here by
default): a request that has streamed zero tokens is resubmitted once onto
a surviving replica; one that already streamed tokens is resumed once —
resubmitted with its emitted history as ``resume_tokens`` so the survivor
re-prefills prompt + history and continues token-exact.  Either way only a
second death fails the request typed FAILED.

``sync()`` is one deterministic membership tick (tests drive it with a
fake clock); ``start_sync()`` wraps it in a daemon thread for wall-clock
deployments.

The durable request plane (:mod:`.journal`) pumps fleet requests through
the inherited :meth:`~.replica.ReplicaSet.stream_batches` — token batches
journal gateway-side before clients see them, so the fleet needs no
journal awareness of its own: worker processes stay stateless across
gateway restarts and the journal replay re-drives onto whichever workers
membership currently routes.
"""
from __future__ import annotations

import threading
import time

from ...core.retry import RetryPolicy
from ...distributed.membership import EXPIRE, JOIN, MembershipService
from ...observability import flight as _flight
from ...testing.faults import InjectedFault as _InjectedFault
from .admission import AlwaysAdmit
from .disagg import RemotePrefillTier
from .replica import ReplicaDeadError, ReplicaSet
from .router import PrefixAffinityRouter
from .rpc import RpcClient, RpcError

__all__ = ["RemoteReplica", "FleetReplicaSet"]


class RemoteReplica:
    """The :class:`~.replica.EngineReplica` facade over a worker's RPC
    endpoint.  Any channel failure (or an injected ``rpc.*`` fault) marks
    the replica dead and raises :class:`~.replica.ReplicaDeadError` — the
    fleet's requeue path takes it from there."""

    def __init__(self, name, host, port, epoch=None, connect_timeout=5.0):
        self.name = str(name)
        self.epoch = epoch
        self.client = RpcClient(host, port, connect_timeout=connect_timeout)
        self.alive = True
        self.error = None

    def _call(self, op, deadline=None, **kw):
        if not self.alive:
            raise ReplicaDeadError(
                f"replica {self.name!r} is dead: {self.error!r}")
        try:
            # thread the ambient trace through every frame: the worker's
            # span events join the caller's timeline with adopted Lamport
            # stamps (wire_context is None for untraced / disabled calls)
            return self.client.call(op, deadline=deadline,
                                    ctx=_flight.wire_context(), **kw)
        except (RpcError, _InjectedFault) as e:
            self.die(e)
            raise ReplicaDeadError(
                f"replica {self.name!r} unreachable: {e}") from e

    def die(self, error):
        """Mark dead (idempotent) — lease expiry and channel failure both
        land here."""
        if self.alive:
            self.alive = False
            self.error = error
        self.client.close()

    def close(self):
        self.client.close()

    # ---- EngineReplica facade ------------------------------------------------
    def submit(self, prompt_ids, **kw):
        return self._call("submit", prompt_ids=list(prompt_ids), **kw)

    def poll(self, rid, timeout=None):
        grace = None if timeout is None else float(timeout) + 30.0
        return self._call("poll", deadline=grace, rid=rid, timeout=timeout)

    def cancel(self, rid):
        return self._call("cancel", rid=rid)

    def status(self, rid):
        return self._call("status", rid=rid)

    def result(self, rid):
        return self._call("result", rid=rid)

    def request_error(self, rid):
        return self._call("request_error", rid=rid)

    def ttft(self, rid):
        try:
            return self._call("ttft", rid=rid)
        except ReplicaDeadError:
            return None

    def tpot(self, rid):
        try:
            return self._call("tpot", rid=rid)
        except ReplicaDeadError:
            return None

    def load(self):
        return self._call("load")

    def prefix_keys(self):
        return self._call("prefix_keys")

    def export_pages(self, keys):
        return self._call("pull_pages", keys=list(keys))

    def import_pages(self, payload):
        return self._call("push_pages", payload=payload)

    def health(self):
        try:
            return self._call("health")
        except ReplicaDeadError:
            return {"replica": self.name, "alive": False,
                    "error": repr(self.error)}

    def metrics(self):
        try:
            return self._call("metrics")
        except ReplicaDeadError:
            return {}

    def metrics_snapshot(self, deadline=None):
        """The worker PROCESS's full registry snapshot (federation pull)."""
        return self._call("metrics_snapshot", deadline=deadline)

    def trace_events(self, trace_id=None, deadline=None):
        """The worker's flight-recorder events for ``trace_id`` (all, when
        None) — the pull half of fleet-wide request tracing."""
        return self._call("trace_events", deadline=deadline,
                          trace_id=trace_id)

    def __repr__(self):
        return (f"RemoteReplica({self.name!r}, epoch={self.epoch}, "
                f"alive={self.alive})")


class FleetReplicaSet(ReplicaSet):
    """ReplicaSet whose members are remote workers joined via membership."""

    def __init__(self, store, group="fleet", ttl=2.0, clock=time.monotonic,
                 router=None, admission=None, requeue=True, page_size=16,
                 connect_timeout=5.0, retry_policy=None, peer_pull=False,
                 peer_pull_min_pages=1):
        # deliberately NOT calling super().__init__: the fleet starts empty
        # and fills from membership events, while the base requires engines
        self.membership = MembershipService(store, group=group, ttl=ttl,
                                            clock=clock,
                                            retry_policy=retry_policy)
        self.watcher = self.membership.watch()
        self.router = (router if router is not None
                       else PrefixAffinityRouter(page_size=page_size))
        self.admission = admission if admission is not None else AlwaysAdmit()
        self.requeue = bool(requeue)
        # peer KV tier over the worker RPC plane (pull_pages/push_pages);
        # off by default — see ReplicaSet.__init__
        self._peer_pull = bool(peer_pull)
        self._peer_pull_min = int(peer_pull_min_pages)
        self._pull_retry = RetryPolicy(max_attempts=3, base_delay=0.01,
                                       max_delay=0.25)
        self.replicas = []
        self._by_name = {}
        # members advertising role == "prefill" are disaggregation prefill
        # tiers, not serving replicas: they never enter routing; a
        # DisaggEngine lists them via remote_prefill=[...]
        self.prefill_tiers: dict = {}
        self._connect_timeout = float(connect_timeout)
        self._sync_thread = None
        self._sync_stop = threading.Event()

    # ---- membership fold -----------------------------------------------------
    def sync(self):
        """One membership tick folded into the routing table; returns the
        events it applied (deterministic — tests call this directly)."""
        events = self.watcher.poll()
        for ev in events:
            if ev.kind == JOIN:
                self._on_join(ev.member)
            else:  # LEAVE / EXPIRE
                self._on_gone(ev.member, expired=(ev.kind == EXPIRE))
        return events

    def _on_join(self, member):
        meta0 = member.meta or {}
        if meta0.get("role") == "prefill":
            old = self.prefill_tiers.pop(member.name, None)
            if old is not None:
                old.close()
            self.prefill_tiers[member.name] = RemotePrefillTier(
                meta0.get("host", "127.0.0.1"), meta0["port"],
                name=member.name, connect_timeout=self._connect_timeout)
            return
        old = self._by_name.get(member.name)
        if old is not None:
            if getattr(old, "epoch", None) == member.epoch:
                return  # already routing this incarnation
            old.die(ReplicaDeadError(
                f"superseded by epoch {member.epoch}"))
        meta = member.meta or {}
        rep = RemoteReplica(member.name, meta.get("host", "127.0.0.1"),
                            meta["port"], epoch=member.epoch,
                            connect_timeout=self._connect_timeout)
        self.add_replica(rep)
        try:
            # prefix_keys covers every tier the worker can serve without
            # recompute — resident HBM pages AND host-RAM spilled chains —
            # so a respawned worker rejoins as warm as its caches really are
            for key in rep.prefix_keys():
                self.router.note_event(rep.name, "register", key)
        except ReplicaDeadError:
            pass  # died between join and warm-up; expiry will reap it

    def _on_gone(self, member, expired):
        tier = self.prefill_tiers.pop(member.name, None)
        if tier is not None:
            tier.close()
            return
        rep = self._by_name.get(member.name)
        if rep is None:
            return
        if expired:
            # stopped heartbeating: inflight polls must fail over, not hang
            rep.die(ReplicaDeadError(
                f"replica {member.name!r} lease expired "
                f"(epoch {member.epoch})"))
        self.remove_replica(member.name)

    # ---- fleet observability -------------------------------------------------
    def _federation_members(self, attr):
        """Extend the base scrape set with the disaggregation prefill
        tiers: they are leased members with registries of their own, just
        not serving replicas, so routing skips them but federation must
        not.  They ride the base class's concurrent scrape and share its
        failure semantics."""
        members = super()._federation_members(attr)
        for name, tier in list(self.prefill_tiers.items()):
            fn = getattr(tier, attr, None)
            if fn is not None:
                members.append((name, fn))
        return members

    # ---- lifecycle -----------------------------------------------------------
    def start_sync(self, interval=0.2):
        """Apply :meth:`sync` every ``interval`` seconds from a daemon
        thread (joined by :meth:`close`)."""
        if self._sync_thread is None:
            self._sync_stop.clear()
            self._sync_thread = threading.Thread(
                target=self._sync_loop, args=(float(interval),),
                name=f"fleet-sync-{self.membership.group}", daemon=True)
            self._sync_thread.start()
        return self

    def _sync_loop(self, interval):
        while not self._sync_stop.wait(interval):
            try:
                self.sync()
            except (OSError, ConnectionError, TimeoutError):
                continue  # store hiccup: next tick retries

    def start(self):
        return self.start_sync()

    def close(self):
        self._sync_stop.set()
        if self._sync_thread is not None:
            self._sync_thread.join(timeout=10.0)
            self._sync_thread = None
        for r in self.replicas:
            r.close()
        for t in self.prefill_tiers.values():
            t.close()
        self.prefill_tiers.clear()
