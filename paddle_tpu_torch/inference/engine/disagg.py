"""Disaggregated prefill/decode serving: an M:N pool of engine cores with
pipelined KV-page handoff between their pools (the counterpart of
``paddle_tpu.inference.engine.disagg``).

The phase-separation argument (DistServe OSDI'24, Splitwise ISCA'24): in a
colocated engine every chunked prefill that lands in a step stalls ALL
co-resident decode slots — the step loop is prefill-first, so a long prompt
arriving mid-stream inflates every other request's inter-token latency.
:class:`DisaggEngine` runs PREFILL engines and DECODE engines, each with
its own weights' head, KV pool and programs; each :meth:`step` always
dispatches the decode side and only additionally dispatches prefill chunks
when the shared handoff queue has room, so decode token cadence is never
blocked behind a prompt.  On one card the engines are independent buffer
sets whose work the card runs one after the other.  Prefill demand is
bursty (Mooncake), so the pool is M:N: any number of prefill engines
(local, or remote worker processes — see below) feed any number of decode
engines through ONE bounded queue, and each drained handoff picks the
least-loaded decode engine at placement time.

The seam is the KV-page handoff: when a prompt finishes prefilling, the
prefill engine's ``prefill_sink`` detaches the request WITH its page
refcounts into the bounded queue.  With ``async_handoff`` (the default)
the transfer is *pipelined*: staging allocates destination pages and
queues the prefill runner's ``gather_pages`` (and ``put_block`` when the
pair's devices differ) for handoff *k+1*, the decode engines run their
step behind it, and the landing half (``scatter_pages`` in place +
``admit_prefilled``) runs at the top of the NEXT round, before that
round's decode.  ``async_handoff=False`` keeps the blocking hop (gather →
put → scatter inline before the decode step).

Where the reference leans on JAX's data dependencies, the port leans on
CUDA stream order: every engine of a process dispatches on the device's
current stream, so a gather is queued before any later write to its source
pages (which the pool releases right after dispatching it, parking
content-registered prompt pages in the prefill LRU: prefix-cache hits
survive disaggregation), and a scatter before the decode engine's next
replayed graph reads them.  ``scatter_pages`` writes the cache in place
(``index_copy_``), so the decode programs' captured graphs, which hold the
cache's addresses, read the landed pages.  A full queue back-pressures
admission: prefill engines stop stepping, their waiting queues grow, and
the ordinary ``max_waiting`` / page-pressure shedding applies.

Placement: each engine holds ONE device (``device=`` for the engines the
pool builds; supplied ``prefill_engines=`` / ``decode_engines=`` keep
their own); a (prefill, decode) pair whose runners' devices differ is
*cross* and its block moves through ``put_block``.  The reference's mesh slices (``split_mesh``,
``prefill_mesh=`` and the rest) wait for multi-device serving and are
refused.

Cross-host: a prefill engine living in a different worker process joins
the pool as a *remote prefill tier* (``remote_prefill=[...]``, duck-typed
— see ``frontend/disagg.py``): the pool submits prompts to it over the
worker RPC plane, and a finished prefill comes back as a serialized host
page block (owned numpy arrays; a bfloat16 cache travels as int16 bit
patterns) that lands through the same queue → stage → scatter pipeline,
``put_block`` of the host block replacing the device-to-device hop.

Fault surface: every handoff fires the ``serving.kv_handoff`` point
BEFORE any page is copied (ctx has ``rids`` and ``path`` —
``local``/``cross_host``), so transient faults retry idempotently under
the shared :class:`RetryPolicy`; a poisoned handoff quarantines ONLY that
request (terminal FAILED, pages released on every engine that held any).

Parity: greedy and fixed-seed requests are token-exact with a colocated
:class:`~.core.LLMEngine` regardless of pool shape, transfer pipelining,
or transport — the copied pages are bit-identical to what the decode
engine would have written (same program, same absolute RoPE positions;
int8 pages and scales copy verbatim), and per-request sampling seeds do
not depend on dispatch structure.  (Seedless sampling draws from a
per-engine global counter and is not parity-stable, exactly as with the
colocated prefix cache.)
"""
from __future__ import annotations

import time
from collections import deque

import numpy as np

from ... import observability as _obs
from ...observability import flight as _flight
from ...core.retry import RetryError, RetryPolicy, retry_call
from ...testing.faults import FAULTS as _faults
from .core import LLMEngine
from .metrics import _PoolMetrics
from .request import Request, RequestStatus

__all__ = ["DisaggEngine"]

# local prefill engine i allocates rids in [i*STRIDE, (i+1)*STRIDE); remote
# tier t gets the namespace after the local engines — rids stay globally
# unique across the pool with zero translation, and the 1:1 default keeps
# the colocated engine's 0, 1, 2, ... sequence exactly
_RID_STRIDE = 1_000_000_000


class _TransientHandoff(Exception):
    """Wrapper so :func:`retry_call` retries exactly the transient handoff
    faults; non-transient errors escape unwrapped into quarantine."""

    def __init__(self, err):
        super().__init__(str(err))
        self.err = err


class _Handoff:
    """One queued prefill→decode transfer: the detached request plus either
    the prefill-side device pages whose refcounts the queue now owns
    (``src`` = local prefill engine index) or, for a cross-host handoff, the
    serialized host page block pulled off a remote prefill tier."""

    __slots__ = ("r", "pages", "n_tokens", "src", "host_block", "path",
                 "t_enqueue", "released")

    def __init__(self, r, pages, n_tokens, src=None, host_block=None,
                 path="local"):
        self.r = r
        self.pages = pages
        self.n_tokens = n_tokens
        self.src = src
        self.host_block = host_block
        self.path = path
        self.t_enqueue = time.perf_counter()
        self.released = False

    @property
    def n_pages(self):
        if self.host_block is None:
            return len(self.pages)
        return int(self.host_block[0].shape[1])


class _Staged:
    """A handoff whose transfer is in flight: destination pages are
    allocated and the gather/device_put dispatched; the landing half
    (scatter + admit) runs after the decode step the copy overlapped."""

    __slots__ = ("h", "j", "dst", "block", "t_staged", "dispatch_s")

    def __init__(self, h, j, dst, block, t_staged, dispatch_s):
        self.h = h
        self.j = j
        self.dst = dst
        self.block = block
        self.t_staged = t_staged
        self.dispatch_s = dispatch_s


class DisaggEngine:
    """M prefill engines + N decode engines + one bounded KV handoff queue.

    Accepts the colocated :class:`LLMEngine` knobs and applies them to both
    sides.  Pool shape: ``n_prefill``/``n_decode`` replicate the engine
    build (``prefill_meshes``/``decode_meshes`` pin each replica to its
    slice — default both 1, two buffer sets on the local device, exactly
    the original 1:1 engine); ``prefill_engines``/``decode_engines`` pass
    pre-built engines instead; ``remote_prefill`` adds remote prefill
    tiers (e.g. :class:`~..frontend.disagg.RemotePrefillTier` handles to
    prefill-role workers) whose handoffs arrive serialized over RPC.
    ``prefix_cache`` lives on the PREFILL side only (that is where prompts
    are computed; a decode-side cache would share the partially-filled
    last prompt page that decode writes into).  ``spec_decode`` lives on
    the DECODE side only.  ``handoff_depth`` bounds the queue;
    ``handoff_retry`` is the :class:`RetryPolicy` for transient
    ``serving.kv_handoff`` faults; ``async_handoff`` pipelines transfers
    under decode compute (False restores the blocking hop)."""

    _pool_seq = 0   # observability label: one series set per pool

    def __init__(self, model=None, prefill_mesh=None, decode_mesh=None,
                 mp_axis=None, pp_axis=None, max_batch=4, max_len=256,
                 page_size=16, prefill_chunk=32, page_pool=None,
                 decode_block=1, seed=0,
                 kv_cache_dtype="auto", decode_block_max=32,
                 prefix_cache=False, spec_decode=None, max_waiting=None,
                 shed_min_free_ratio=0.0, default_deadline=None,
                 step_retry=None, debug_refcount_audit=False,
                 handoff_depth=4, handoff_retry=None,
                 n_prefill=1, n_decode=1, prefill_meshes=None,
                 decode_meshes=None, prefill_engines=None,
                 decode_engines=None, remote_prefill=None,
                 async_handoff=True, device="cuda"):
        """device: where every engine the pool builds lives (default the
        card; raises without CUDA unless ``device="cpu"``).  Engines
        supplied through ``prefill_engines`` / ``decode_engines`` keep the
        device they were built on.

        The mesh knobs (``prefill_mesh``, ``decode_mesh``,
        ``prefill_meshes``, ``decode_meshes``, ``mp_axis``, ``pp_axis``)
        need multi-device serving, which is not ported yet: any of them
        raises, as ``LLMEngine(mesh=)`` does."""
        meshes = {"prefill_mesh": prefill_mesh, "decode_mesh": decode_mesh,
                  "prefill_meshes": prefill_meshes,
                  "decode_meshes": decode_meshes, "mp_axis": mp_axis,
                  "pp_axis": pp_axis}
        given = [k for k, v in meshes.items() if v is not None]
        if given:
            raise NotImplementedError(
                f"multi-device serving ({', '.join(given)}) is not ported "
                "yet; place the engines with device= or prefill_engines= / "
                "decode_engines=")
        self.max_batch = max_batch
        self.max_len = max_len
        self.page = page_size
        self.debug_refcount_audit = bool(debug_refcount_audit)
        self.handoff_depth = int(handoff_depth)
        self._async = bool(async_handoff)
        self._handoff_retry = (handoff_retry if handoff_retry is not None
                               else RetryPolicy(max_attempts=3,
                                                base_delay=0.01,
                                                max_delay=0.25, seed=seed))
        common = dict(max_batch=max_batch, max_len=max_len,
                      page_size=page_size, prefill_chunk=prefill_chunk,
                      page_pool=page_pool, seed=seed,
                      kv_cache_dtype=kv_cache_dtype,
                      default_deadline=default_deadline,
                      step_retry=step_retry)
        # internal engines run with their own audits off — handoff-held
        # pages are invisible to a single engine's slot tables, so only the
        # combined audit_refcounts() below knows the full expected counts
        if prefill_engines is not None:
            self.prefills = list(prefill_engines)
        else:
            self.prefills = [
                LLMEngine(model, device=device, prefix_cache=prefix_cache,
                          max_waiting=max_waiting,
                          shed_min_free_ratio=shed_min_free_ratio,
                          debug_refcount_audit=False, **common)
                for _ in range(int(n_prefill))]
        if decode_engines is not None:
            self.decodes = list(decode_engines)
        else:
            self.decodes = [
                LLMEngine(model, device=device, decode_block=decode_block,
                          decode_block_max=decode_block_max,
                          spec_decode=spec_decode,
                          debug_refcount_audit=False, **common)
                for _ in range(int(n_decode))]
        self.remote = list(remote_prefill) if remote_prefill else []
        if not self.decodes:
            raise ValueError("DisaggEngine needs at least one decode engine")
        if not self.prefills and not self.remote:
            raise ValueError("DisaggEngine needs at least one prefill "
                             "engine (local or remote)")
        for i, pe in enumerate(self.prefills):
            pe._next_rid += i * _RID_STRIDE
            pe.prefill_sink = (
                lambda slot, token, _i=i: self._sink(_i, slot, token))
        # one hop or zero per (prefill, decode) pair: device_put only when
        # the pair's device sets really differ
        self._cross = [[set(pe.runner.devices) != set(de.runner.devices)
                        for de in self.decodes] for pe in self.prefills]
        self._queue: deque = deque()          # unstaged handoffs, FIFO
        self._queued: dict = {}               # rid -> live _Handoff (O(1))
        self._staged: deque = deque()         # transfers in flight
        self._staged_by_rid: dict = {}
        self._staged_slots = [0] * len(self.decodes)  # slots reserved
        # remote tier bookkeeping: pool_rid -> (tier idx, worker rid,
        # placeholder Request in the POOL's clock domain)
        self._remote_pending: dict = {}
        self._remote_counters = [0] * len(self.remote)
        self._pf_rr = 0                 # round-robin prefill step cursor
        self.handoffs = 0               # completed page transfers
        self.handoff_retries = 0        # transient kv_handoff retries
        self.handoff_failures = 0       # handoffs quarantined as poison
        self.queue_wait_s = 0.0         # total queue wait before dispatch
        self.transfer_s = 0.0           # transfer wall decode could not hide
        self.transfer_overlap_s = 0.0   # in-flight time hidden under decode
        self.prefix_cache = (self.pre.prefix_cache
                             if self.pre is not None else False)
        self._pm = _PoolMetrics(str(DisaggEngine._pool_seq))
        DisaggEngine._pool_seq += 1

    # ------------------------------------------------------------ structure
    @property
    def pre(self):
        """First local prefill engine (the 1:1 back-compat alias; None for
        a pool fed only by remote tiers)."""
        return self.prefills[0] if self.prefills else None

    @property
    def dec(self):
        """First decode engine (the 1:1 back-compat alias)."""
        return self.decodes[0]

    # --------------------------------------------------------------- intake
    def add_request(self, prompt_ids, max_new_tokens, eos_token_id=None,
                    **kw):
        """Submit a request to the least-loaded prefill engine (waiting +
        active; remote tiers weigh in with their locally-tracked inflight
        count, ties prefer local engines in index order).  Admission
        control runs on the chosen prefill side; a full handoff queue
        back-pressures it by pausing prefill steps, which grows the
        waiting queue into the ``max_waiting`` / page-pressure shed
        rules."""
        if len(self.prefills) == 1 and not self.remote:
            return self.pre.add_request(prompt_ids, max_new_tokens,
                                        eos_token_id, **kw)
        cands = [(len(pe.sched.waiting)
                  + sum(1 for s in pe.sched.slots if s is not None), 0, i)
                 for i, pe in enumerate(self.prefills)]
        cands += [(int(getattr(t, "load", lambda: 0)()), 1, j)
                  for j, t in enumerate(self.remote)]
        _, kind, idx = min(cands)
        if kind == 0:
            return self.prefills[idx].add_request(prompt_ids, max_new_tokens,
                                                  eos_token_id, **kw)
        return self._submit_remote(idx, prompt_ids, max_new_tokens,
                                   eos_token_id, **kw)

    def _submit_remote(self, t, prompt_ids, max_new_tokens, eos_token_id,
                       **kw):
        """Route a request to remote prefill tier ``t``: the worker assigns
        its own rid; the pool assigns a pool-wide rid from the tier's
        stride namespace and keeps a placeholder Request so status /
        cancel / deadline expiry work before the block is pulled."""
        tier = self.remote[t]
        wrid = tier.submit(
            [int(x) for x in np.asarray(prompt_ids).reshape(-1)],
            max_new_tokens=max_new_tokens, eos_token_id=eos_token_id, **kw)
        pool_rid = ((len(self.prefills) + t) * _RID_STRIDE
                    + self._remote_counters[t])
        self._remote_counters[t] += 1
        placeholder = Request(
            pool_rid, prompt_ids, max_new_tokens, eos_token_id,
            do_sample=kw.get("do_sample", False),
            temperature=kw.get("temperature", 1.0),
            top_p=kw.get("top_p", 1.0), top_k=kw.get("top_k", 0),
            seed=kw.get("seed"), deadline=kw.get("deadline"))
        ctx = _flight.current()
        if ctx is not None:
            placeholder.trace_id = ctx.trace_id
            _flight.record("remote_submit", rid=pool_rid,
                           trace_id=ctx.trace_id, tier=tier.name, wrid=wrid)
        self._remote_pending[pool_rid] = (t, wrid, placeholder)
        return pool_rid

    def cancel(self, rid):
        """Cancel wherever the request lives: a prefill engine, the handoff
        queue (O(1) by rid), a staged in-flight transfer, a remote prefill
        tier, or a decode engine."""
        for pe in self.prefills:
            if pe.cancel(rid):
                return True
        h = self._queued.get(rid)
        if h is not None:
            self._release_queued(h, RequestStatus.CANCELLED)
            return True
        s = self._staged_by_rid.get(rid)
        if s is not None:
            # transfer already in flight: finalize now; _land releases the
            # destination pages when the block arrives
            self.decodes[0].sched.finalize(s.h.r, RequestStatus.CANCELLED)
            return True
        ent = self._remote_pending.pop(rid, None)
        if ent is not None:
            t, wrid, placeholder = ent
            try:
                self.remote[t].cancel(wrid)
            except (ConnectionError, OSError):
                pass          # tier unreachable: membership will reap it
            self.decodes[0].sched.finalize(placeholder,
                                           RequestStatus.CANCELLED)
            return True
        return any(de.cancel(rid) for de in self.decodes)

    # -------------------------------------------------------------- handoff
    def _sink(self, i, slot, token):
        """``prefill_sink`` for local prefill engine ``i``: emit the first
        token there (TTFT is a prefill-side responsibility), then — unless
        that token already finished the request — detach the slot with its
        page refcounts into the shared handoff queue."""
        pe = self.prefills[i]
        r = pe.sched.slots[slot]
        pe.sched.emit(slot, token)
        if pe.sched.slots[slot] is not r:
            return                 # max_new==1 / eos at first token: done
        req, pages, n_tokens = pe.sched.detach(slot)
        if req.trace_id is not None:
            _flight.record("handoff_queued", rid=req.rid,
                           trace_id=req.trace_id, src=i, n_tokens=n_tokens)
        h = _Handoff(req, pages, n_tokens, src=i)
        self._queue.append(h)
        self._queued[req.rid] = h

    def _drop_src_pages(self, h):
        if h.src is not None:
            pool = self.prefills[h.src].pool
            for p in h.pages:
                pool.unref_page(p)
        h.pages = ()

    def _release_queued(self, h, status, error=None):
        """The ONE path that releases a queued handoff's page refs and
        finalizes its request — cancel, deadline expiry, and fail_all all
        land here so the two bookkeeping halves can never drift.  The
        deque keeps a tombstone that ``_stage``/``_drain_sync`` pop lazily
        (cancel stays O(1))."""
        self._queued.pop(h.r.rid, None)
        h.released = True
        self._drop_src_pages(h)
        self.decodes[0].sched.finalize(h.r, status, error=error)

    def _place(self, h):
        """Least-loaded decode placement: among decode engines with a free
        slot (net of slots already reserved by staged transfers) and
        enough free pages, pick the lowest (active + staged + waiting)
        load, ties to the lowest index; allocate and return
        ``(engine_idx, dst_pages)``, or None when nothing can take the
        handoff yet."""
        best, best_load = None, None
        for j, de in enumerate(self.decodes):
            free_slots = (sum(1 for s in de.sched.slots if s is None)
                          - self._staged_slots[j])
            if free_slots <= 0:
                continue
            if de.pool.n_available() < h.n_pages:
                continue
            load = (sum(1 for s in de.sched.slots if s is not None)
                    + self._staged_slots[j] + len(de.sched.waiting))
            if best_load is None or load < best_load:
                best, best_load = j, load
        if best is None:
            return None
        de, dst = self.decodes[best], []
        for _ in range(h.n_pages):
            p = de.pool.alloc_page()
            if p is None:             # raced below n_available: back off
                for q in dst:
                    de.pool.unref_page(q)
                return None
            dst.append(p)
        return best, dst

    def _dispatch(self, h, j):
        """Fire the fault point, then dispatch the transfer: jitted gather
        off the source slice plus ``device_put`` onto the decode slice's
        sharding when the pair crosses device sets (a cross-host block is
        already host-resident and only needs the put).  Dispatch is
        asynchronous — the returned device block is in flight, and the
        landing scatter chains on it.  Transient faults retry under the
        shared policy; the fault fires before any copy, so a retry is
        idempotent."""
        def attempt():
            _faults.maybe_fire("serving.kv_handoff", rids=[h.r.rid],
                               path=h.path)
            if h.host_block is not None:
                return self.decodes[j].runner.put_block(h.host_block)
            block = self.prefills[h.src].runner.gather_pages(h.pages)
            if self._cross[h.src][j]:
                block = self.decodes[j].runner.put_block(block)
            return block

        def xfer():
            try:
                return attempt()
            except Exception as err:
                if getattr(err, "transient", False):
                    self.handoff_retries += 1
                    raise _TransientHandoff(err) from err
                raise

        return retry_call(xfer, policy=self._handoff_retry,
                          retry_on=(_TransientHandoff,),
                          op="serving.kv_handoff")

    def _next_placeable(self):
        """Head of the handoff queue placed onto a decode engine, with
        tombstones from O(1) cancel/expiry popped along the way.  FIFO —
        order preserves fairness; a head that cannot be placed blocks the
        queue.  Returns ``(handoff, engine_idx, dst_pages)`` or None."""
        while self._queue:
            h = self._queue[0]
            if h.released or h.r.status.terminal:
                self._queue.popleft()
                continue
            placed = self._place(h)
            if placed is None:
                return None
            self._queue.popleft()
            self._queued.pop(h.r.rid, None)
            wait = time.perf_counter() - h.t_enqueue
            self.queue_wait_s += wait
            self._pm.wait[h.path].observe(wait)
            return h, placed[0], placed[1]
        return None

    def _quarantine(self, h, j, dst, err):
        if isinstance(err, RetryError):
            err = err.__cause__.err
        self.handoff_failures += 1
        de = self.decodes[j]
        for p in dst:
            de.pool.unref_page(p)
        self._drop_src_pages(h)
        de.sched.finalize(h.r, RequestStatus.FAILED, error=err)
        if h.r.trace_id is not None:
            # pin AFTER finalize so the dumped post-mortem includes the
            # terminal span
            _flight.pin(h.r.trace_id, "poison_quarantine")

    def _stage(self):
        """Async pipeline, send half: dispatch the transfer for every
        placeable queued handoff and reserve its decode slot.  The copies
        run while the NEXT decode step computes; ``_land`` completes
        them."""
        while True:
            nxt = self._next_placeable()
            if nxt is None:
                return
            h, j, dst = nxt
            t0 = time.perf_counter()
            try:
                block = self._dispatch(h, j)
            except Exception as err:  # noqa: BLE001 — quarantine boundary
                self._quarantine(h, j, dst, err)
                continue
            dispatch_s = time.perf_counter() - t0
            if h.r.trace_id is not None:
                _flight.record("handoff_dispatch", rid=h.r.rid,
                               trace_id=h.r.trace_id, dur=dispatch_s,
                               dst=j, path=h.path)
            # the dispatched gather owns the data: source refs can go now,
            # parking content-registered prompt pages in the prefill LRU
            self._drop_src_pages(h)
            s = _Staged(h, j, dst, block, time.perf_counter(), dispatch_s)
            self._staged.append(s)
            self._staged_by_rid[h.r.rid] = s
            self._staged_slots[j] += 1

    def _land(self):
        """Async pipeline, receive half: seat every staged transfer whose
        copy the decode step just overlapped — admit into the reserved
        slot, then scatter the block into the destination pages.  A
        request cancelled while in flight only releases its destination
        pages here."""
        while self._staged:
            s = self._staged[0]
            de = self.decodes[s.j]
            if s.h.r.status.terminal:       # cancelled/failed in flight
                self._staged.popleft()
                self._staged_by_rid.pop(s.h.r.rid, None)
                self._staged_slots[s.j] -= 1
                for p in s.dst:
                    de.pool.unref_page(p)
                continue
            t0 = time.perf_counter()
            slot = de.sched.admit_prefilled(s.h.r, s.dst, s.h.n_tokens)
            if slot is None:
                # a preemption readmit took the reserved slot: wait for
                # the next step's _land, pages and block stay held
                return
            self._staged.popleft()
            self._staged_by_rid.pop(s.h.r.rid, None)
            self._staged_slots[s.j] -= 1
            de.runner.scatter_pages(s.dst, s.block)
            land_s = time.perf_counter() - t0
            if s.h.r.trace_id is not None:
                _flight.record("handoff_land", rid=s.h.r.rid,
                               trace_id=s.h.r.trace_id, dur=land_s,
                               dst=s.j, path=s.h.path)
            self.transfer_s += s.dispatch_s + land_s
            self.transfer_overlap_s += max(0.0, t0 - s.t_staged)
            self._pm.transfer[s.h.path].observe(s.dispatch_s + land_s)
            self.handoffs += 1

    def _drain_sync(self):
        """Blocking hop (``async_handoff=False``): move every placeable
        handoff into a decode slot inline — gather, device_put, scatter,
        admit, all before the next decode step dispatches.  The original
        1:1 engine's behavior, kept as the bench's sync comparator."""
        while True:
            nxt = self._next_placeable()
            if nxt is None:
                return
            h, j, dst = nxt
            de = self.decodes[j]
            t0 = time.perf_counter()
            try:
                block = self._dispatch(h, j)
            except Exception as err:  # noqa: BLE001 — quarantine boundary
                self._quarantine(h, j, dst, err)
                continue
            de.runner.scatter_pages(dst, block)
            de.sched.admit_prefilled(h.r, dst, h.n_tokens)
            self._drop_src_pages(h)
            dt = time.perf_counter() - t0
            if h.r.trace_id is not None:
                _flight.record("handoff_land", rid=h.r.rid,
                               trace_id=h.r.trace_id, dur=dt, dst=j,
                               path=h.path)
            self.transfer_s += dt
            self._pm.transfer[h.path].observe(dt)
            self.handoffs += 1

    def _expire_queue(self):
        """Deadline expiry for work the pool itself holds: queued handoffs
        release through the same shared path as cancel; remote pending
        placeholders cancel tier-side and finalize TIMEOUT locally."""
        now = time.perf_counter()
        expired = [h for h in self._queued.values()
                   if h.r.deadline is not None and now > h.r.deadline]
        for h in expired:
            self._release_queued(h, RequestStatus.TIMEOUT)
        for pool_rid, (t, wrid, placeholder) in list(
                self._remote_pending.items()):
            if placeholder.deadline is None or now <= placeholder.deadline:
                continue
            del self._remote_pending[pool_rid]
            try:
                self.remote[t].cancel(wrid)
            except (ConnectionError, OSError):
                pass
            self.decodes[0].sched.finalize(placeholder,
                                           RequestStatus.TIMEOUT)

    # --------------------------------------------------------- remote tiers
    def _fail_tier(self, t, err):
        """A remote tier's channel died: fail its pending requests with a
        typed terminal status instead of hanging them forever."""
        for pool_rid, ent in list(self._remote_pending.items()):
            if ent[0] != t:
                continue
            del self._remote_pending[pool_rid]
            self.decodes[0].sched.finalize(ent[2], RequestStatus.FAILED,
                                           error=err)

    def _pull_remote(self):
        """Pull finished prefills off every remote tier into the shared
        handoff queue (bounded by ``handoff_depth`` — backpressure crosses
        the host boundary too).  The ``serving.kv_handoff`` fault fires
        pool-side BEFORE the pull RPC (ctx ``path="cross_host"``), so a
        transient retry re-issues the pull against a worker that still
        holds the block; poison quarantines only that request on both
        sides."""
        for t, tier in enumerate(self.remote):
            if not any(ent[0] == t for ent in self._remote_pending.values()):
                continue
            if len(self._queued) >= self.handoff_depth:
                return
            try:
                ready = tier.poll_ready()
            except (ConnectionError, OSError) as err:
                self._fail_tier(t, err)
                continue
            by_worker = {ent[1]: pool_rid for pool_rid, ent
                         in self._remote_pending.items() if ent[0] == t}
            for wrid in ready:
                pool_rid = by_worker.get(wrid)
                if pool_rid is None:
                    continue          # not ours / already resolved
                if len(self._queued) >= self.handoff_depth:
                    break
                self._pull_one(t, tier, wrid, pool_rid)

    def _pull_one(self, t, tier, wrid, pool_rid):
        def pull():
            try:
                _faults.maybe_fire("serving.kv_handoff", rids=[pool_rid],
                                   path="cross_host")
                return tier.pull(wrid)
            except Exception as err:
                if getattr(err, "transient", False):
                    self.handoff_retries += 1
                    raise _TransientHandoff(err) from err
                raise

        try:
            payload = retry_call(pull, policy=self._handoff_retry,
                                 retry_on=(_TransientHandoff,),
                                 op="serving.kv_handoff")
        except Exception as err:  # noqa: BLE001 — quarantine boundary
            if isinstance(err, RetryError):
                err = err.__cause__.err
            self.handoff_failures += 1
            _, _, placeholder = self._remote_pending.pop(pool_rid)
            try:
                tier.fail(wrid)
            except (ConnectionError, OSError):
                pass
            self.decodes[0].sched.finalize(placeholder, RequestStatus.FAILED,
                                           error=err)
            if placeholder.trace_id is not None:
                _flight.pin(placeholder.trace_id, "poison_quarantine")
            return
        _, _, placeholder = self._remote_pending.pop(pool_rid)
        r = payload["req"]
        # rebase into the pool's namespace and clock domain: the worker's
        # perf_counter origin is not ours, and its rid is not unique here
        r.rid = pool_rid
        r.t_submit = placeholder.t_submit
        r.deadline = placeholder.deadline
        r.stream_pos = 0
        if r.trace_id is None:
            r.trace_id = placeholder.trace_id
        if r.trace_id is not None:
            _flight.record("handoff_pulled", rid=pool_rid,
                           trace_id=r.trace_id, tier=tier.name, wrid=wrid)
        if payload["block"] is None:
            # finished at the first prefill token (max_new==1 / instant
            # eos): terminal worker-side, nothing to transfer — record the
            # completed request pool-side as-is
            self.decodes[0].sched.finished[pool_rid] = r
            return
        h = _Handoff(r, (), int(payload["n_tokens"]), src=None,
                     host_block=payload["block"], path="cross_host")
        self._queue.append(h)
        self._queued[pool_rid] = h

    # ----------------------------------------------------------------- step
    def step(self):
        """One disaggregated scheduling round.  Async (default): land the
        transfers staged LAST round (scatter + admit — their copies had a
        full round to fly), stage freshly queued ones (dispatch gather +
        device_put), then step every decode engine; transfer k overlaps
        round k's tail and the requests it carries decode in round k+1,
        same seating latency as the blocking hop but without its stall.
        Sync: drain inline before the decode step (the blocking hop).
        Prefill engines step only while the handoff queue has room
        (backpressure), and fresh handoffs stage immediately so their copy
        overlaps the NEXT decode step.  Returns #slots served across all
        slices."""
        if self._queued or self._remote_pending:
            self._expire_queue()
        if self._remote_pending:
            self._pull_remote()
        if self._async:
            self._land()
            self._stage()
        else:
            self._drain_sync()
        served = 0
        for de in self.decodes:
            served += de.step()
        # at most ONE prefill engine steps per pool round (round-robin over
        # the busy ones): the in-process pool serializes all dispatch, so
        # stepping every busy engine would grow the per-round wall O(M) and
        # re-block the decode cadence disaggregation exists to protect.
        # Remote tiers prefill truly in parallel in their own processes.
        n_pf = len(self.prefills)
        for k in range(n_pf):
            if len(self._queued) >= self.handoff_depth:
                break
            i = (self._pf_rr + k) % n_pf
            pe = self.prefills[i]
            if (pe.sched.waiting
                    or any(s is not None for s in pe.sched.slots)):
                served += pe.step()
                self._pf_rr = (i + 1) % n_pf
                break
        # a prompt that just finished prefilling goes straight for a decode
        # slot: sync admits now, async dispatches the copy so it hides
        # under the next step's decode
        if self._queue:
            if self._async:
                self._stage()
            else:
                self._drain_sync()
        self._pm.queue_depth.set(len(self._queued))
        if self.debug_refcount_audit:
            problems = self.audit_refcounts()
            if problems:
                raise RuntimeError("page-refcount audit failed:\n  "
                                   + "\n  ".join(problems))
        return served

    def run_until_done(self, max_steps=10000):
        steps = 0
        while self.has_work() and steps < max_steps:
            self.step()
            steps += 1
        return steps

    def has_work(self):
        return bool(
            self._queued or self._staged or self._remote_pending
            or any(pe.sched.waiting
                   or any(s is not None for s in pe.sched.slots)
                   for pe in self.prefills)
            or any(de.sched.waiting
                   or any(s is not None for s in de.sched.slots)
                   for de in self.decodes))

    # ------------------------------------------------------------ accessors
    def _lookup(self, rid):
        for pe in self.prefills:
            for r in pe.sched.waiting:
                if r.rid == rid:
                    return r
            for r in pe.sched.slots:
                if r is not None and r.rid == rid:
                    return r
        h = self._queued.get(rid)
        if h is not None:
            return h.r
        s = self._staged_by_rid.get(rid)
        if s is not None:
            return s.h.r
        ent = self._remote_pending.get(rid)
        if ent is not None:
            return ent[2]
        for de in self.decodes:
            for r in de.sched.slots:
                if r is not None and r.rid == rid:
                    return r
            for r in de.sched.waiting:    # decode-side preemption requeue
                if r.rid == rid:
                    return r
            if rid in de.sched.finished:
                return de.sched.finished[rid]
        for pe in self.prefills:
            if rid in pe.sched.finished:
                return pe.sched.finished[rid]
        raise KeyError(rid)

    def result(self, rid):
        r = self._lookup(rid)
        if not r.status.terminal:
            raise KeyError(rid)
        return r.out

    def status(self, rid):
        return self._lookup(rid).status

    def error(self, rid):
        return self._lookup(rid).error

    def ttft(self, rid):
        return self._lookup(rid).ttft

    def tpot(self, rid):
        r = self._lookup(rid)
        if r.t_finish is None or r.ttft is None or len(r.out) < 2:
            return None
        return (r.t_finish - r.t_submit - r.ttft) / (len(r.out) - 1)

    def new_tokens(self, rid):
        r = self._lookup(rid)
        toks = [int(t) for t in r.out[r.stream_pos:]]
        r.stream_pos += len(toks)
        return toks

    def fail_all(self, error):
        for pe in self.prefills:
            pe.fail_all(error)
        for h in list(self._queued.values()):
            self._release_queued(h, RequestStatus.FAILED, error=error)
        self._queue.clear()
        while self._staged:
            s = self._staged.popleft()
            self._staged_by_rid.pop(s.h.r.rid, None)
            self._staged_slots[s.j] -= 1
            de = self.decodes[s.j]
            for p in s.dst:
                de.pool.unref_page(p)
            if not s.h.r.status.terminal:
                de.sched.finalize(s.h.r, RequestStatus.FAILED, error=error)
        for pool_rid, (t, wrid, placeholder) in list(
                self._remote_pending.items()):
            del self._remote_pending[pool_rid]
            try:
                self.remote[t].cancel(wrid)
            except (ConnectionError, OSError):
                pass
            self.decodes[0].sched.finalize(placeholder, RequestStatus.FAILED,
                                           error=error)
        for de in self.decodes:
            de.fail_all(error)

    def audit_refcounts(self):
        """Combined page-accounting audit across EVERY slice: each prefill
        pool's expected refcounts include the handoff queue's holds (pages
        detached from a slot but not yet dispatched), each decode pool's
        include the staged transfers' destination pages (allocated but not
        yet seated in a slot table); remote tiers are asked to audit
        themselves over RPC.  Empty list means clean."""
        problems = []
        for i, pe in enumerate(self.prefills):
            expected = pe.sched.expected_refs(pe.n_pages)
            for h in self._queued.values():
                if h.src == i:
                    for p in h.pages:
                        expected[p] += 1
            tag = "prefill" if len(self.prefills) == 1 else f"prefill[{i}]"
            problems += [f"{tag}: {m}" for m in pe.pool.audit(expected)]
        for j, de in enumerate(self.decodes):
            expected = de.sched.expected_refs(de.n_pages)
            for s in self._staged:
                if s.j == j:
                    for p in s.dst:
                        expected[p] += 1
            tag = "decode" if len(self.decodes) == 1 else f"decode[{j}]"
            problems += [f"{tag}: {m}" for m in de.pool.audit(expected)]
        for t, tier in enumerate(self.remote):
            fn = getattr(tier, "audit", None)
            if fn is None:
                continue
            try:
                problems += [f"remote[{t}]: {m}" for m in fn()]
            except (ConnectionError, OSError) as err:
                problems += [f"remote[{t}]: audit unreachable: {err}"]
        return problems

    def spec_stats(self):
        if len(self.decodes) == 1:
            return self.dec.spec_stats()
        agg: dict = {}
        for de in self.decodes:
            for k, v in de.spec_stats().items():
                agg[k] = (agg.get(k, 0) + v
                          if isinstance(v, (int, float)) else v)
        return agg

    def prefix_cache_stats(self):
        if self.pre is None:
            return {}
        if len(self.prefills) == 1:
            return self.pre.prefix_cache_stats()
        agg: dict = {}
        for pe in self.prefills:
            for k, v in pe.prefix_cache_stats().items():
                agg[k] = (agg.get(k, 0) + v
                          if isinstance(v, (int, float)) else v)
        return agg

    def handoff_stats(self):
        """Always-on counters and timings for the prefill→decode seam —
        the in-process mirror of the ``serving_handoff_*`` registry
        families.  ``queue_wait_s`` totals time handoffs sat queued before
        their transfer dispatched; ``transfer_s`` totals transfer wall the
        decode loop could NOT hide (async: dispatch + land halves; sync:
        the whole blocking hop); ``transfer_overlap_s`` totals in-flight
        time hidden under decode compute (async only — the pipelining
        evidence)."""
        return {
            "handoffs": self.handoffs,
            "queued": len(self._queued),
            "staged": len(self._staged),
            "remote_pending": len(self._remote_pending),
            "depth": self.handoff_depth,
            "retries": self.handoff_retries,
            "failures": self.handoff_failures,
            "cross_device": (any(any(row) for row in self._cross)
                             or bool(self.remote)),
            "async": self._async,
            "n_prefill": len(self.prefills) + len(self.remote),
            "n_decode": len(self.decodes),
            "queue_wait_s": self.queue_wait_s,
            "transfer_s": self.transfer_s,
            "transfer_overlap_s": self.transfer_overlap_s,
        }

    def health(self):
        """Combined liveness snapshot: per-slice engine health plus the
        handoff seam counters (1:1 keeps the original ``prefill`` /
        ``decode`` keys; larger pools add per-replica lists)."""
        h = {
            "prefill": self.pre.health() if self.pre is not None else None,
            "decode": self.dec.health(),
            "handoff": self.handoff_stats(),
        }
        if len(self.prefills) > 1:
            h["prefills"] = [pe.health() for pe in self.prefills]
        if len(self.decodes) > 1:
            h["decodes"] = [de.health() for de in self.decodes]
        return h

    @property
    def preemptions(self):
        return (sum(pe.sched.preemptions for pe in self.prefills)
                + sum(de.sched.preemptions for de in self.decodes))
