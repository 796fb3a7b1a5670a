"""Cross-host prefill tier: the worker side and pool side of a KV handoff
that crosses a process boundary.

A *prefill worker* is an ordinary :class:`~.worker.WorkerServer` started
with ``role="prefill"``: its engine gets a
:class:`PrefillHandoffBuffer` installed as ``prefill_sink``, so a prompt
that finishes prefilling is detached from its slot, its KV pages gathered
to host RAM (the ``pages_to_host`` spill idiom — owned numpy arrays), the
device pages released back to the worker's pool, and the serialized block
parked until the decode-side pool pulls it.  The worker advertises
``role`` in its membership lease meta, and its RPC surface grows four ops
(``handoff_ready`` / ``handoff_pull`` / ``handoff_cancel`` /
``handoff_audit``) that ride the same protocol-5 out-of-band framing as
``pull_pages``/``push_pages`` — the page block crosses the wire without an
in-band pickle copy.

:class:`RemotePrefillTier` is the pool-side handle a
:class:`~..engine.disagg.DisaggEngine` lists in ``remote_prefill=[...]``:
``submit`` routes a prompt to the worker, ``poll_ready``/``pull`` drain
finished prefills back as ``{"req", "block", "n_tokens"}`` payloads that
land through the pool's ordinary queue → stage → scatter pipeline, and
``audit`` folds the worker's page accounting into the pool's combined
refcount audit.  :class:`~.fleet.FleetReplicaSet` builds these
automatically for members that advertise ``role == "prefill"``.
"""
from __future__ import annotations

import copy
import threading

from ...observability import flight as _flight
from ..serving import RequestStatus
from .rpc import RpcClient

__all__ = ["PrefillHandoffBuffer", "RemotePrefillTier"]


class PrefillHandoffBuffer:
    """Worker-side half of a cross-host handoff: a ``prefill_sink`` that
    serializes each finished prefill to host RAM and parks it for pull.

    The sink runs on the replica's step thread with the engine condition
    held, so engine state needs no extra locking; the parked map has its
    own lock because ``ready``/``pull``/``drop`` arrive on RPC threads.
    Parked entries hold NO device pages — the block is host memory and the
    worker's pool refs are released in the sink — so a pulled-then-lost
    payload can never leak device pages, and the worker's refcount audit
    stays clean whatever the pool does."""

    def __init__(self, engine):
        self.engine = engine
        self._lock = threading.Lock()
        self._parked: dict = {}       # worker rid -> payload dict
        self.parked_total = 0         # lifetime sink count (stats)
        engine.prefill_sink = self._sink

    def _sink(self, slot, token):
        eng = self.engine
        r = eng.sched.slots[slot]
        eng.sched.emit(slot, token)
        if eng.sched.slots[slot] is not r:
            # the first token already finished it (max_new==1 / instant
            # eos): emit() finalized and released the slot — park the
            # completed request itself, nothing to transfer
            payload = {"req": copy.copy(r), "block": None, "n_tokens": 0}
        else:
            req, pages, n_tokens = eng.sched.detach(slot)
            block = eng.runner.pages_to_host(pages)
            for p in pages:          # block owns the data: device refs go,
                eng.pool.unref_page(p)   # prompt pages park in the LRU
            # copy BEFORE finalize so the payload request stays RUNNING
            # with pos == len(prompt) — exactly what admit_prefilled wants
            payload = {"req": copy.copy(req), "block": block,
                       "n_tokens": int(n_tokens)}
            eng.sched.finalize(req, RequestStatus.FINISHED)
        payload["req"].slot = None
        payload["req"].stream_pos = 0
        if r.trace_id is not None:
            _flight.record("handoff_parked", rid=r.rid, trace_id=r.trace_id,
                           n_tokens=payload["n_tokens"])
        with self._lock:
            self._parked[r.rid] = payload
            self.parked_total += 1

    def ready(self):
        """Worker rids with a parked block awaiting pull."""
        with self._lock:
            return list(self._parked)

    def pull(self, rid):
        """Hand the parked payload over (removing it).  KeyError for an
        unknown rid — the pool quarantines that request."""
        with self._lock:
            return self._parked.pop(rid)

    def drop(self, rid):
        """Discard a parked payload (pool-side cancel/poison).  True when
        something was dropped."""
        with self._lock:
            return self._parked.pop(rid, None) is not None


class RemotePrefillTier:
    """Pool-side handle to a prefill-role worker, duck-typed for
    ``DisaggEngine(remote_prefill=[...])``: submit / poll_ready / pull /
    cancel / fail / load / audit / close.  ``load()`` is the locally
    tracked inflight count (submitted minus pulled/failed) so the pool's
    least-loaded routing never pays an RPC per placement decision."""

    def __init__(self, host, port, name=None, connect_timeout=5.0,
                 call_timeout=60.0):
        self.name = str(name) if name is not None else f"{host}:{port}"
        self.client = RpcClient(host, port, connect_timeout=connect_timeout,
                                call_timeout=call_timeout)
        self._inflight = 0

    def submit(self, prompt_ids, **kw):
        rid = self.client.call("submit", ctx=_flight.wire_context(),
                               prompt_ids=list(prompt_ids), **kw)
        self._inflight += 1
        return rid

    def poll_ready(self):
        return self.client.call("handoff_ready", ctx=_flight.wire_context())

    def pull(self, rid):
        payload = self.client.call("handoff_pull",
                                   ctx=_flight.wire_context(), rid=rid)
        self._inflight = max(0, self._inflight - 1)
        return payload

    def cancel(self, rid):
        try:
            return self.client.call("handoff_cancel",
                                    ctx=_flight.wire_context(), rid=rid)
        finally:
            self._inflight = max(0, self._inflight - 1)

    # poison quarantine drops the worker-side payload the same way a
    # cancel does; the pool records the FAILED terminal on its own side
    fail = cancel

    def load(self):
        return self._inflight

    def audit(self):
        return self.client.call("handoff_audit", ctx=_flight.wire_context())

    def metrics_snapshot(self, deadline=None):
        """The prefill worker's full registry snapshot (federation pull)."""
        return self.client.call("metrics_snapshot", deadline=deadline,
                                ctx=None)

    def trace_events(self, trace_id=None, deadline=None):
        """The prefill worker's flight-recorder events for ``trace_id``."""
        return self.client.call("trace_events", deadline=deadline, ctx=None,
                                trace_id=trace_id)

    def close(self):
        self.client.close()

    def __repr__(self):
        return f"RemotePrefillTier({self.name!r}, inflight={self._inflight})"
