"""Replica worker: one engine in its own OS process, leased into the fleet.

A worker is the fleet's unit of failure isolation: it hosts one
``LLMEngine`` behind the same :class:`~.replica.EngineReplica` facade the
in-process front door uses, serves the replica ops over the
:mod:`~paddle_tpu_torch.inference.frontend.rpc` channel, and holds a
:class:`~paddle_tpu_torch.distributed.membership.Lease` whose heartbeat is the
worker's liveness signal — a crash (any kind, including ``kill -9``) stops
the renewals and the fleet expires the member one TTL later, while a
SIGTERM drains gracefully: stop admitting, finish inflight, release the
lease so watchers see ``leave`` immediately.

:class:`WorkerServer` is host-agnostic on purpose — production runs it
under ``python -m paddle_tpu_torch.inference.frontend.worker`` as a supervised
child process, the deterministic tier-1 tests run several in threads of
one process with an injected clock, and the bench does the same to measure
degradation without TPU-sized process images.

RPC ops: ``submit poll cancel status result request_error ttft tpot load
health metrics metrics_snapshot trace_events prefix_keys pull_pages
push_pages ping``.  ``metrics_snapshot`` returns the worker process's FULL
metrics-registry snapshot (every family, not just the engine counters) for
gateway-side federation, and ``trace_events`` returns the flight recorder's
picklable span events — the pull half of fleet-wide request tracing.  ``pull_pages`` /
``push_pages`` are the peer KV tier's transfer halves: a gateway pulls a
serialized page-chain block out of the replica that holds it and pushes it
into the replica it routed to.  ``submit`` while draining raises
:class:`~.admission.ShedError` ("draining") so the gateway's shed path
handles the race between drain and route.

``role="prefill"`` turns the worker into a disaggregation prefill tier: a
:class:`~.disagg.PrefillHandoffBuffer` hooks the engine's
``prefill_sink``, the lease meta advertises the role, and four more ops
serve the handoff plane — ``handoff_ready handoff_pull handoff_cancel
handoff_audit`` (see :mod:`.disagg`).
"""
from __future__ import annotations

import os
import signal
import threading
import time

from ... import observability as _obs
from ...distributed.membership import MembershipService
from ...observability import flight as _flight
from .admission import ShedError
from .disagg import PrefillHandoffBuffer
from .replica import EngineReplica
from .rpc import RpcServer

__all__ = ["WorkerServer", "load_engine_factory", "main"]


class WorkerServer:
    """One leased engine replica served over RPC.

    ``store`` is a connected :class:`~paddle_tpu_torch.distributed.store.TCPStore`
    client; the membership meta advertises ``host``/``port`` of the RPC
    endpoint (plus ``pid``), which is all a gateway needs to build a remote
    replica handle.
    """

    def __init__(self, name, engine, store, group="fleet", ttl=2.0,
                 host="127.0.0.1", port=0, clock=time.monotonic,
                 heartbeat_interval=None, retry_policy=None,
                 poll_interval=0.05, role="serve"):
        self.name = str(name)
        self.role = str(role)
        self.handoff = (PrefillHandoffBuffer(engine)
                        if self.role == "prefill" else None)
        self.replica = EngineReplica(self.name, engine,
                                     poll_interval=poll_interval)
        self.rpc = RpcServer(self._handle, host, port)
        self.membership = MembershipService(store, group=group, ttl=ttl,
                                            clock=clock,
                                            retry_policy=retry_policy)
        self.lease = None
        self.lease_lost = None
        self.draining = False
        self._hb_interval = heartbeat_interval
        self._poll = float(poll_interval)

    # ---- lifecycle -----------------------------------------------------------
    def start(self, heartbeat=True):
        """Start the engine loop + RPC listener, then register the lease.
        ``heartbeat=False`` leaves renewal to the caller (deterministic
        tests drive :meth:`Lease.renew` by hand)."""
        self.replica.start()
        self.rpc.start()
        self.lease = self.membership.register(self.name, meta={
            "host": self.rpc.host, "port": self.rpc.port,
            "pid": os.getpid(), "role": self.role})
        if heartbeat:
            self.lease.start_heartbeat(self._hb_interval,
                                       on_lost=self._on_lease_lost)
        return self

    def _on_lease_lost(self, error):
        # the fleet has (or will) expire us; remember why for health()
        self.lease_lost = error

    def drain(self, timeout=30.0):
        """Graceful drain: refuse new submits, wait for inflight work to
        finish (bounded by ``timeout``), release the lease."""
        self.draining = True
        deadline = time.monotonic() + float(timeout)
        while (self.replica.alive and self.replica.load() > 0
               and time.monotonic() < deadline):
            time.sleep(self._poll)
        if self.lease is not None:
            self.lease.release()

    def close(self, drain=True, drain_timeout=30.0):
        if drain:
            self.drain(drain_timeout)
        elif self.lease is not None:
            self.lease.release()
        self.rpc.close()
        self.replica.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # ---- RPC dispatch --------------------------------------------------------
    def _handle(self, op, kw):
        # RPC connection threads vary per call: label each so worker-side
        # span events (queued, routed-to-us submits) name this worker
        _flight.set_proc_label(f"worker:{self.name}")
        rep = self.replica
        if op == "submit":
            if self.draining:
                raise ShedError("draining", retry_after=1.0)
            return rep.submit(kw.pop("prompt_ids"), **kw)
        if op == "poll":
            return rep.poll(kw["rid"], timeout=kw.get("timeout"))
        if op == "cancel":
            return rep.cancel(kw["rid"])
        if op == "status":
            return rep.status(kw["rid"])
        if op == "result":
            return rep.result(kw["rid"])
        if op == "request_error":
            return rep.request_error(kw["rid"])
        if op == "ttft":
            return rep.ttft(kw["rid"])
        if op == "tpot":
            return rep.tpot(kw["rid"])
        if op == "load":
            return rep.load()
        if op == "health":
            h = rep.health()
            h["draining"] = self.draining
            h["epoch"] = self.lease.epoch if self.lease else None
            h["lease_lost"] = (repr(self.lease_lost)
                               if self.lease_lost else None)
            return h
        if op == "metrics":
            return rep.metrics()
        if op == "metrics_snapshot":
            # the WHOLE process registry (engine + frontend + durable-plane
            # families), not just the engine's counters: the gateway merges
            # this under a replica= label for the federated /metrics page
            return _obs.REGISTRY.snapshot()
        if op == "trace_events":
            return _flight.snapshot_events(kw.get("trace_id"))
        if op == "prefix_keys":
            return rep.prefix_keys()
        if op == "pull_pages":
            return rep.export_pages(kw["keys"])
        if op == "push_pages":
            return rep.import_pages(kw["payload"])
        if op == "handoff_ready":
            return self.handoff.ready() if self.handoff is not None else []
        if op == "handoff_pull":
            if self.handoff is None:
                raise ValueError(
                    f"worker {self.name!r} has role={self.role!r}, not a "
                    "prefill tier")
            return self.handoff.pull(kw["rid"])
        if op == "handoff_cancel":
            if self.handoff is not None and self.handoff.drop(kw["rid"]):
                return True
            return rep.cancel(kw["rid"])
        if op == "handoff_audit":
            return self.audit_pages()
        # liveness probe for operators and the fleet tests — the gateway
        # itself never calls it, so CT101 sees no site in the package
        if op == "ping":  # graftlint: disable=contracts
            return {"name": self.name,
                    "epoch": self.lease.epoch if self.lease else None,
                    "pid": os.getpid()}
        raise ValueError(f"unknown worker op {op!r}")

    def audit_pages(self):
        """Page-refcount audit of the hosted engine, under the replica's
        engine condition — the worker-side half of a disaggregation pool's
        combined dual-pool audit (empty list means clean)."""
        rep = self.replica
        with rep._cv:
            eng = rep.engine
            fn = getattr(eng, "audit_refcounts", None)
            if fn is not None:
                return list(fn())
            return list(eng.pool.audit(
                eng.sched.expected_refs(eng.n_pages)))


def load_engine_factory(spec):
    """Resolve ``--engine-spec``: ``pkg.module:attr`` or ``/path/file.py:attr``
    (attr defaults to ``make_engine``).  The factory is called with no
    arguments and must return a constructed ``LLMEngine``."""
    path, _, attr = str(spec).partition(":")
    attr = attr or "make_engine"
    if path.endswith(".py"):
        import importlib.util
        modspec = importlib.util.spec_from_file_location("_worker_engine",
                                                         path)
        mod = importlib.util.module_from_spec(modspec)
        modspec.loader.exec_module(mod)
    else:
        import importlib
        mod = importlib.import_module(path)
    return getattr(mod, attr)


def main(argv=None):
    """``python -m paddle_tpu_torch.inference.frontend.worker`` — the supervised
    child-process entry.  Blocks until SIGTERM (graceful drain) or death."""
    import argparse

    from ...distributed.store import TCPStore

    p = argparse.ArgumentParser(description="paddle-tpu fleet worker")
    p.add_argument("--engine-spec", required=True,
                   help="module:attr or file.py:attr engine factory")
    p.add_argument("--name", required=True)
    p.add_argument("--store-host", default="127.0.0.1")
    p.add_argument("--store-port", type=int, required=True)
    p.add_argument("--group", default="fleet")
    p.add_argument("--ttl", type=float, default=2.0)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=0)
    p.add_argument("--heartbeat-interval", type=float, default=None)
    p.add_argument("--drain-timeout", type=float, default=30.0)
    p.add_argument("--role", default="serve", choices=("serve", "prefill"),
                   help="'prefill' parks finished prefills for a "
                        "disaggregation pool instead of decoding")
    args = p.parse_args(argv)

    engine = load_engine_factory(args.engine_spec)()
    store = TCPStore(host=args.store_host, port=args.store_port)
    server = WorkerServer(args.name, engine, store, group=args.group,
                          ttl=args.ttl, host=args.host, port=args.port,
                          heartbeat_interval=args.heartbeat_interval,
                          role=args.role)
    server.start()

    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *_: stop.set())
    signal.signal(signal.SIGINT, lambda *_: stop.set())
    stop.wait()
    server.close(drain=True, drain_timeout=args.drain_timeout)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
