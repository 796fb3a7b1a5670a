"""Host scheduling: admission, slot tables, deadlines, preemption, and the
request lifecycle — everything between ``add_request`` and a terminal status
that does not touch a device buffer.

:class:`Scheduler` owns the waiting queue, the per-slot page tables /
lengths, and the finished map; it allocates through a
:class:`~.pages.PagePool` and the only device operation it can trigger is
the injected ``copy_page`` callable (the copy half of copy-on-write, bound
to :meth:`~.runner.ModelRunner.copy_page` by the engine).  The
:class:`~.core.LLMEngine` facade drives it: ``admit()`` at step entry,
``emit()`` per generated token, ``release()/preempt_youngest()`` on the
failure and pool-pressure paths.

``detach()`` / ``admit_prefilled()`` are the disaggregation seam: detach
lifts a freshly-prefilled request out of its slot WITHOUT dropping its page
references (ownership moves to the caller — the KV handoff queue), and
admit_prefilled seats a request whose pages were written elsewhere, skipping
prefill entirely.
"""
from __future__ import annotations

import math
import time
from collections import deque

import numpy as np

from ...observability import flight as _flight
from .request import RequestStatus, prefix_page_keys

__all__ = ["Scheduler"]


class Scheduler:
    """Continuous-batching scheduler over one PagePool."""

    def __init__(self, pool, max_batch, max_len, page_size, pages_per_slot,
                 prefix_cache=False, copy_page=None, metrics=None,
                 max_waiting=None, shed_min_free_ratio=0.0,
                 restore_chain=None):
        self.pool = pool
        self.max_batch = int(max_batch)
        self.max_len = int(max_len)
        self.page = int(page_size)
        self.pages_per_slot = int(pages_per_slot)
        self.prefix_cache = bool(prefix_cache)
        self._copy_page = copy_page          # device page copy (CoW)
        # host-tier restore: restore_chain([keys]) -> physical pages it
        # managed to bring back on-device, in order (engine-injected, same
        # contract as copy_page — may be shorter than asked on failure)
        self._restore_chain = restore_chain
        self._m = metrics
        self.max_waiting = None if max_waiting is None else int(max_waiting)
        self.shed_min_free_ratio = float(shed_min_free_ratio)
        self.slots: list = [None] * self.max_batch
        self.slot_tables = np.zeros((self.max_batch, self.pages_per_slot),
                                    np.int32)
        self.lens = np.zeros((self.max_batch,), np.int32)
        self.n_alloc = np.zeros((self.max_batch,), np.int32)
        self.waiting: deque = deque()
        self.finished: dict = {}
        self._admit_seq = 0
        self.preemptions = 0
        self.shed_requests = 0          # refused by admission control
        self.timeouts = 0               # deadline expiries (waiting + active)
        self.cancels = 0                # cancel(rid) that found the request
        self.quarantined = 0            # requests isolated as FAILED

    # ----------------------------------------------------- request lifecycle
    def should_shed(self):
        """Watermark admission control over the same gauges metrics()
        exports: a bounded waiting queue, plus a page-pressure floor that
        sheds while a backlog already exists (an idle engine always admits —
        a single fresh request can still run via preemption)."""
        if self.max_waiting is not None \
                and len(self.waiting) >= self.max_waiting:
            return True
        if self.shed_min_free_ratio > 0.0 and self.waiting:
            # LRU pages the host tier could absorb are reclaimable WITHOUT
            # recompute loss, so with a spill tier attached the same
            # watermark sheds later
            avail = self.pool.n_available(host_headroom=True)
            if avail < self.shed_min_free_ratio * self.pool.n_usable:
                return True
        return False

    def finalize(self, r, status, error=None):
        """Move ``r`` to its typed terminal status (the ONLY path into
        ``finished``), mirroring the terminal counters."""
        r.status = status
        r.done = True
        r.slot = None
        if error is not None:
            r.error = f"{type(error).__name__}: {error}"
        r.t_finish = time.perf_counter()
        self.finished[r.rid] = r
        if r.trace_id is not None:
            _flight.record("terminal", rid=r.rid, trace_id=r.trace_id,
                           status=status.value, error=r.error,
                           tokens=len(r.out))
        if status is RequestStatus.SHED:
            self.shed_requests += 1
        elif status is RequestStatus.TIMEOUT:
            self.timeouts += 1
        elif status is RequestStatus.CANCELLED:
            self.cancels += 1
        elif status is RequestStatus.FAILED:
            self.quarantined += 1
        if self._m is not None:
            self._m.terminal[status].inc()

    def cancel(self, rid):
        """Cancel a request wherever it is: waiting (dequeued) or mid-serve
        (slot released — pages return through the refcount machinery, so
        prefix-cache pages other slots share stay live).  Returns True if
        the request was found live; False if unknown or already terminal."""
        for i, r in enumerate(self.waiting):
            if r.rid == rid:
                del self.waiting[i]
                self.finalize(r, RequestStatus.CANCELLED)
                return True
        for slot, r in enumerate(self.slots):
            if r is not None and r.rid == rid:
                self.release(slot, RequestStatus.CANCELLED)
                return True
        return False

    def expire_deadlines(self):
        """Deadline sweep at step entry: expired waiting requests are shed
        unserved; an expired in-flight request finalizes cleanly (partial
        output kept, pages released).  Both end TIMEOUT."""
        now = time.perf_counter()
        if self.waiting:
            expired = [r for r in self.waiting
                       if r.deadline is not None and now > r.deadline]
            if expired:
                keep = deque(r for r in self.waiting
                             if not (r.deadline is not None
                                     and now > r.deadline))
                self.waiting.clear()
                self.waiting.extend(keep)
                for r in expired:
                    self.finalize(r, RequestStatus.TIMEOUT)
        for slot, r in enumerate(self.slots):
            if r is not None and r.deadline is not None and now > r.deadline:
                self.release(slot, RequestStatus.TIMEOUT)

    # ------------------------------------------------------ page accounting
    def page_keys(self, tokens):
        """Chain keys of ``tokens``' full pages (see
        :func:`~.request.prefix_page_keys` — shared with the frontend
        router)."""
        return prefix_page_keys(tokens, self.page)

    def cow_unshare(self, slot, start, n):
        """Copy-on-write before a prefill write into [start, start+n): any
        touched page another slot still maps (refcount > 1) gets a private
        copy so the write can't clobber the shared prefix. Hit on exactly
        one path: a fully-cached prompt re-prefills its final token into the
        last shared page."""
        pool = self.pool
        for j in range(start // self.page, (start + n - 1) // self.page + 1):
            p = int(self.slot_tables[slot, j])
            while int(pool.page_ref[p]) > 1:
                # RL102 sees preempt_youngest between alloc and rollback,
                # but it only runs while q is None (nothing held)
                q = pool.alloc_page()  # graftlint: disable=resource_lifecycle
                if q is None:
                    # preemption may release the OTHER reference, making the
                    # copy unnecessary — the while re-checks
                    if not self.preempt_youngest(excluding=slot):
                        raise RuntimeError(
                            "page pool exhausted during copy-on-write — "
                            "engine misconfigured (max_len vs page pool)")
                    continue
                try:
                    self._copy_page(p, q)
                except BaseException:
                    pool.unref_page(q)   # unwritten copy frees cleanly
                    raise
                pool.cache_cow_copies += 1
                if self._m is not None:
                    self._m.cow.inc()
                pool.page_ref[p] -= 1
                self.slot_tables[slot, j] = q
                if j == int(self.n_alloc[slot]) - 1:
                    self.slot_tables[slot, j + 1:] = q   # repoint padding
                p = q

    def register_pages(self, slot, r):
        """Hash-register every completed full prompt page of this slot so
        later requests can hit it. First registration wins; a page whose
        content another physical page already serves stays private."""
        for j in range(int(self.lens[slot]) // self.page):
            self.pool.register(int(self.slot_tables[slot, j]),
                               r.cache_keys[j])

    def admit(self):
        pool = self.pool
        for slot in range(self.max_batch):
            if self.slots[slot] is not None or not self.waiting:
                continue
            r = self.waiting[0]
            # on-demand paging: reserve only the PROMPT's pages; decode
            # grows page-by-page (cf. the r3 engine's worst-case
            # prompt+max_new reservation, which gave paging no benefit)
            need = math.ceil(len(r.prompt) / self.page)
            keys = self.page_keys(r.prompt) if self.prefix_cache else []
            # the longest servable key prefix, walked across BOTH device
            # tiers: (key, page) for a resident HBM page, (key, None) for a
            # spilled chain entry to restore — a chain may interleave them
            # (restored pages re-evicted while later pages stayed resident)
            plan = []
            for key in keys:
                p = pool.lookup(key)
                if p is not None:
                    plan.append((key, p))
                elif pool.host is not None and key in pool.host \
                        and self._restore_chain is not None:
                    plan.append((key, None))
                else:
                    break
            n_dev = sum(1 for _, p in plan if p is not None)
            # pages admission must newly claim; hit pages sitting in the LRU
            # are about to be re-referenced, so they are NOT allocatable.
            # Host restores allocate from the same free/LRU budget as fresh
            # pages, so they count as claims here too.
            fresh = need - n_dev
            avail = pool.n_available(
                reserved_lru=sum(1 for _, p in plan
                                 if p is not None and p in pool.lru))
            if avail < fresh:
                break
            self.waiting.popleft()
            # ref HBM hits BEFORE allocating/restoring so eviction can't
            # take them out from under the plan.  RL102 can't follow the
            # branch-aware rollbacks: the short-restore path unrefs past
            # the gap below, and the alloc-fail path unrefs everything
            for _, p in plan:
                if p is not None:
                    pool.ref_page(p)  # graftlint: disable=resource_lifecycle
            # bring spilled runs back on-device in plan order; a short
            # restore truncates the usable cached prefix at the first gap
            pages, n_restored, usable, i = [], 0, len(plan), 0
            while i < usable:
                key, p = plan[i]
                if p is not None:
                    pages.append(p)
                    i += 1
                    continue
                run = []
                while i + len(run) < len(plan) \
                        and plan[i + len(run)][1] is None:
                    run.append(plan[i + len(run)][0])
                t0 = time.perf_counter()
                got = self._restore_chain(run)
                if r.trace_id is not None:
                    _flight.record("spill_restore", rid=r.rid,
                                   trace_id=r.trace_id,
                                   dur=time.perf_counter() - t0,
                                   asked=len(run), restored=len(got))
                pages.extend(got)
                n_restored += len(got)
                if len(got) < len(run):
                    usable = i + len(got)
                    # HBM hits past the gap are unreachable without it —
                    # drop the references taken above
                    for _, q in plan[usable:]:
                        if q is not None:
                            pool.unref_page(q)
                    break
                i += len(run)
            cached = len(pages)
            aborted = False
            for _ in range(need - cached):
                p = pool.alloc_page()
                if p is None:
                    # allocation failed mid-admission (injected fault, or a
                    # racing claim): roll the claimed pages back and requeue
                    # the request at the front — never a half-built table.
                    # Restored pages are content-registered, so unref parks
                    # them in the LRU with their contents intact.
                    for q in pages:
                        pool.unref_page(q)
                    self.waiting.appendleft(r)
                    aborted = True
                    break
                pages.append(p)
            if aborted:
                break
            self.slot_tables[slot, :need] = pages
            self.slot_tables[slot, need:] = pages[-1]
            self.n_alloc[slot] = need
            # skip prefill over fully-cached pages. At least the prompt's
            # FINAL token always re-prefills: its logits sample the first
            # output token (a 100%-cached prompt therefore re-enters its
            # last shared page, which is the copy-on-write path).
            skip = min(cached * self.page, len(r.prompt) - 1)
            pool.record_admission(cached, len(keys) - cached,
                                  n_host=n_restored)
            r.cache_keys = keys
            r.cached_tokens = skip
            r.pos = skip
            self.lens[slot] = skip
            r.slot = slot
            r.status = RequestStatus.RUNNING
            r.admit_seq = self._admit_seq
            self._admit_seq += 1
            self.slots[slot] = r

    def release(self, slot, status=None, error=None):
        """Free the slot's pages through the refcounts; ``status`` None is
        the requeue path (preemption — the request is NOT finalized), any
        terminal status finalizes the request."""
        r = self.slots[slot]
        for p in self.slot_tables[slot, :int(self.n_alloc[slot])]:
            self.pool.unref_page(int(p))
        self.slots[slot] = None
        self.lens[slot] = 0
        self.n_alloc[slot] = 0
        if status is not None:
            self.finalize(r, status, error=error)

    def preempt_youngest(self, excluding):
        """Free the youngest slot's pages, requeueing it for recompute
        (prompt := prompt + generated so far). Returns True if one was
        preempted."""
        victims = [(r.admit_seq, s) for s, r in enumerate(self.slots)
                   if r is not None and s != excluding]
        if not victims:
            return False
        _, slot = max(victims)
        r = self.slots[slot]
        # recompute prompt = ORIGINAL prompt + everything generated so far —
        # folding the current (possibly already-folded) prompt would
        # duplicate earlier output on a second preemption
        r.prompt = r.prompt0 + r.out
        if self.prefix_cache and self.pool.host is not None:
            # with a spill tier attached, content-register the victim's
            # completed pages under the FOLDED prompt's chain keys before
            # releasing: release then parks them in the LRU (spillable)
            # instead of freeing them, so preemption degrades to a copy
            # rather than a recompute when the victim re-admits
            keys = self.page_keys(r.prompt)
            for j in range(min(int(self.lens[slot]) // self.page,
                               len(keys))):
                self.pool.register(int(self.slot_tables[slot, j]), keys[j])
        self.release(slot, status=None)
        r.slot = None
        r.status = RequestStatus.QUEUED
        self.waiting.appendleft(r)
        self.preemptions += 1
        if self._m is not None:
            self._m.preempt.inc()
        return True

    def ensure_page(self, slot, ahead=1):
        """Grow slot's page table to cover `ahead` more tokens; preempt the
        youngest other slot if the pool is dry."""
        needed = (int(self.lens[slot]) + ahead + self.page - 1) // self.page
        while int(self.n_alloc[slot]) < needed:
            # RL102 sees preempt_youngest between alloc and the slot-table
            # store, but it only runs while p is None (nothing held)
            p = self.pool.alloc_page()  # graftlint: disable=resource_lifecycle
            if p is None:
                if not self.preempt_youngest(excluding=slot):
                    raise RuntimeError(
                        "page pool exhausted with a single slot — engine "
                        "misconfigured (max_len vs page pool)")
                continue
            na = int(self.n_alloc[slot])
            self.slot_tables[slot, na] = p
            self.slot_tables[slot, na + 1:] = p
            self.n_alloc[slot] = na + 1

    def truncate_pages(self, slot):
        """Free pages past ceil(lens/page) back to the pool — the rollback
        half of speculative decoding. Safe by construction: pages past the
        prompt are always privately allocated (refcount 1) and never
        registered in the prefix index, so a partially-filled page is
        truncated, never shared; the stale KV beyond lens is unreachable
        because attention masks by context length."""
        lens = int(self.lens[slot])
        needed = max(1, (lens + self.page - 1) // self.page)
        na = int(self.n_alloc[slot])
        if na <= needed:
            return
        for j in range(needed, na):
            self.pool.unref_page(int(self.slot_tables[slot, j]))
        self.slot_tables[slot, needed:] = self.slot_tables[slot, needed - 1]
        self.n_alloc[slot] = needed

    def emit(self, slot, token):
        """Record one generated token; release the slot when finished."""
        r = self.slots[slot]
        r.out.append(int(token))
        if self._m is not None:
            self._m.tokens.inc()
        if r.ttft is None:
            r.ttft = time.perf_counter() - r.t_submit
            if self._m is not None:
                self._m.ttft.observe(r.ttft)
            if r.trace_id is not None:
                _flight.record("first_token", rid=r.rid,
                               trace_id=r.trace_id, ttft=r.ttft)
        hit_eos = (r.eos is not None and r.out[-1] == r.eos)
        if (len(r.out) >= r.max_new or hit_eos
                or int(self.lens[slot]) >= self.max_len):
            self.release(slot, RequestStatus.EOS if hit_eos
                         else RequestStatus.FINISHED)

    # ------------------------------------------------------- disaggregation
    def detach(self, slot):
        """Lift the slot's request out WITHOUT dropping its page references
        — ownership of the refcounts moves to the caller (the KV handoff
        queue).  Returns ``(request, pages, n_tokens)`` where ``pages`` are
        the slot's allocated physical pages in table order and ``n_tokens``
        the cached length they cover."""
        r = self.slots[slot]
        pages = [int(p) for p in
                 self.slot_tables[slot, :int(self.n_alloc[slot])]]
        n_tokens = int(self.lens[slot])
        self.slots[slot] = None
        self.lens[slot] = 0
        self.n_alloc[slot] = 0
        r.slot = None
        return r, pages, n_tokens

    def free_slot(self):
        """Index of an empty slot, or None."""
        for slot in range(self.max_batch):
            if self.slots[slot] is None:
                return slot
        return None

    def admit_prefilled(self, r, pages, n_tokens):
        """Seat a request whose KV pages were written elsewhere (the
        receive half of a prefill→decode handoff).  ``pages`` must already
        carry this scheduler's pool references (the caller allocated them);
        ``r.pos`` must equal ``len(r.prompt)`` so the step loop never
        re-prefills.  Returns the slot, or None when the batch is full.

        Blocks arriving from ANOTHER process (the cross-host handoff) are
        validated here — the one choke point both the local and remote
        paths share — so a malformed transfer fails loudly instead of
        seating a slot whose lengths and tables disagree."""
        if not pages:
            raise ValueError(
                f"admit_prefilled(rid={r.rid}): no pages — a prefilled "
                "request owns at least one KV page")
        n_tokens = int(n_tokens)
        if not 0 < n_tokens <= len(pages) * self.page:
            raise ValueError(
                f"admit_prefilled(rid={r.rid}): n_tokens={n_tokens} does "
                f"not fit {len(pages)} pages of {self.page} tokens")
        if r.pos != len(r.prompt):
            raise ValueError(
                f"admit_prefilled(rid={r.rid}): pos={r.pos} != prompt len "
                f"{len(r.prompt)} — request was not fully prefilled")
        slot = self.free_slot()
        if slot is None:
            return None
        need = len(pages)
        self.slot_tables[slot, :need] = pages
        self.slot_tables[slot, need:] = pages[-1]
        self.n_alloc[slot] = need
        self.lens[slot] = n_tokens
        r.slot = slot
        r.status = RequestStatus.RUNNING
        r.admit_seq = self._admit_seq
        self._admit_seq += 1
        self.slots[slot] = r
        return slot

    # ----------------------------------------------------------------- misc
    def lookup(self, rid):
        """The live or terminal :class:`Request` for ``rid`` wherever it
        is — waiting, in a slot, or finished.  KeyError when unknown."""
        for r in self.waiting:
            if r.rid == rid:
                return r
        for r in self.slots:
            if r is not None and r.rid == rid:
                return r
        return self.finished[rid]

    def fail_all(self, error):
        """Finalize EVERY live request (waiting and running) as FAILED with
        ``error`` recorded — the front door calls this when a replica's
        step loop dies, so inflight requests end with a typed terminal
        status instead of hanging their streams forever."""
        while self.waiting:
            self.finalize(self.waiting.popleft(), RequestStatus.FAILED,
                          error=error)
        for slot, r in enumerate(self.slots):
            if r is not None:
                self.release(slot, RequestStatus.FAILED, error=error)

    def expected_refs(self, n_pages):
        """Per-page reference counts implied by the slot tables — the audit
        baseline; the caller adds any handoff holds before
        :meth:`~.pages.PagePool.audit`."""
        expected = np.zeros(n_pages, np.int64)
        for slot, r in enumerate(self.slots):
            if r is None:
                continue
            for j in range(int(self.n_alloc[slot])):
                expected[int(self.slot_tables[slot, j])] += 1
        return expected
