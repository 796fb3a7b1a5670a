"""Paged-KV accounting: the host half of the engine's KV memory manager.

:class:`PagePool` owns every *host-side* page structure — the free list, the
per-page refcounts, the chain-hash prefix index, and the reclaimable LRU —
while the device arrays the pages index into live in
:class:`~.runner.ModelRunner`.  The split is the engine-core refactor's
contract: the pool never touches a device buffer (copy-on-write's device
copy is a callable injected by the engine — and so is the spill tier's
device→host gather, ``spill_page``), and the runner never sees a refcount.

:class:`HostPageStore` is the host-RAM spill tier behind the LRU: when a
host store is attached, LRU eviction copies the page's contents to host
RAM (keyed by the same chain key) instead of discarding them, and the
scheduler's admission walk restores spilled chains back into fresh device
pages instead of re-prefilling.  The store has its own byte budget and LRU;
entries are immutable host copies that no slot table ever references, so
its refcount discipline reduces to exact byte accounting (checked by
:meth:`HostPageStore.audit`, folded into :meth:`PagePool.audit`).

Invariants (checked by :meth:`audit`):

- a page's refcount equals the number of slot-table references to it (plus
  any in-flight handoff references the caller declares),
- free and LRU-parked pages carry refcount 0 and never overlap,
- no page leaks (refcount 0 yet neither free nor parked),
- LRU pages are content-registered and the prefix key index is symmetric,
- the host tier's byte ledger matches its entries and respects its budget.
"""
from __future__ import annotations

from collections import OrderedDict, deque

import numpy as np

from ...testing.faults import FAULTS as _faults

__all__ = ["HostPageStore", "PagePool"]


class HostPageStore:
    """Byte-budgeted host-RAM tier for spilled KV pages.

    One entry per chain key: the page's full contents as a tuple of host
    numpy arrays (one ``[L, 1, page, ...]`` array per cache component),
    copied off-device with the non-blocking snapshot idiom.  Entries are
    LRU-ordered; ``put`` evicts oldest-first until the new entry fits and
    refuses entries larger than the whole budget.  ``on_evict(key)`` fires
    for every evicted entry so the pool can drop the chain key from the
    frontend router's mirror when no device copy remains."""

    def __init__(self, budget_bytes, on_evict=None):
        self.budget = int(budget_bytes)
        self.entries: OrderedDict = OrderedDict()   # chain key -> host block
        self.bytes_used = 0
        self.on_evict = on_evict
        self.spills = 0            # entries accepted by put()
        self.spill_bytes = 0       # bytes accepted by put()
        self.evictions = 0         # entries evicted to fit newer spills

    def __contains__(self, key):
        return key in self.entries

    def __len__(self):
        return len(self.entries)

    @staticmethod
    def block_bytes(block):
        return sum(int(a.nbytes) for a in block)

    def get(self, key):
        """The host block for ``key`` (LRU-refreshed), or None."""
        block = self.entries.get(key)
        if block is not None:
            self.entries.move_to_end(key)
        return block

    def touch(self, key):
        """LRU-refresh ``key`` without reading it; True when present."""
        if key in self.entries:
            self.entries.move_to_end(key)
            return True
        return False

    def put(self, key, block):
        """Admit one spilled page; True when the store holds it afterwards.
        Oldest entries are evicted until the newcomer fits; a block larger
        than the whole budget is refused (the caller falls back to plain
        eviction — recompute)."""
        if key in self.entries:
            self.entries.move_to_end(key)
            return True
        nbytes = self.block_bytes(block)
        if nbytes > self.budget:
            return False
        while self.bytes_used + nbytes > self.budget and self.entries:
            k, old = self.entries.popitem(last=False)
            self.bytes_used -= self.block_bytes(old)
            self.evictions += 1
            if self.on_evict is not None:
                self.on_evict(k)
        self.entries[key] = block
        self.bytes_used += nbytes
        self.spills += 1
        self.spill_bytes += nbytes
        return True

    def pop(self, key):
        block = self.entries.pop(key, None)
        if block is not None:
            self.bytes_used -= self.block_bytes(block)
        return block

    def keys(self):
        return list(self.entries)

    def headroom_pages(self, bytes_per_page):
        """How many more pages the remaining budget could absorb."""
        if bytes_per_page <= 0:
            return 0
        return max(0, (self.budget - self.bytes_used) // int(bytes_per_page))

    def audit(self):
        """Byte-ledger invariants; returns problem strings (empty = clean)."""
        problems = []
        actual = sum(self.block_bytes(b) for b in self.entries.values())
        if actual != self.bytes_used:
            problems.append(f"host tier byte ledger {self.bytes_used} != "
                            f"{actual} actual entry bytes")
        if self.bytes_used > self.budget:
            problems.append(f"host tier over budget: {self.bytes_used} > "
                            f"{self.budget}")
        return problems


class PagePool:
    """Refcounted page allocator with an optional chain-hash prefix index.

    ``n_pages`` INCLUDES the trash page (``n_pages - 1``), which is never
    allocated — it absorbs the masked-out writes of inactive batch rows.
    ``metrics`` is an optional object carrying bound registry counters
    (``hits`` / ``misses`` / ``evictions`` / ``cow``); every metric touch is
    guarded so the pool works metric-less (the disagg prefill/decode slices
    each bind their own engine's metrics)."""

    def __init__(self, n_pages, prefix_cache=False, metrics=None):
        self.n_pages = int(n_pages)
        self.trash_page = self.n_pages - 1
        self.free_pages = deque(range(self.n_pages - 1))
        self.page_ref = np.zeros(self.n_pages, np.int64)
        self.prefix_cache = bool(prefix_cache)
        # optional (event, chain_key) callback — the frontend router
        # subscribes here to mirror this engine's radix index ("register" on
        # page registration, "evict" on LRU reclaim) into its per-replica
        # affinity index.  Called from inside step(); must be cheap and
        # must not raise.
        self.cache_event_listener = None
        self.page_key: dict = {}          # physical page -> chain key
        self.key_page: dict = {}          # chain key -> physical page
        self.lru: OrderedDict = OrderedDict()  # cached, refcount==0 pages
        self.cache_hits = 0                # pages served from cache (admit)
        self.cache_misses = 0              # full prompt pages not cached
        self.cache_evictions = 0           # cached pages reclaimed from LRU
        self.cache_cow_copies = 0          # copy-on-write page copies
        self._m = metrics
        # ---- optional host-RAM spill tier (attach_host) -------------------
        self.host: HostPageStore | None = None
        # engine-injected device→host gather: spill_page(p) -> host block or
        # None on failure (same injection contract as the CoW copy_page — the
        # pool never touches device buffers itself)
        self.spill_page = None
        self.host_hits = 0                 # admission pages restored from host
        self._host_page_bytes = 0

    # ------------------------------------------------------------- refcounts
    def ref_page(self, p):
        self.page_ref[p] += 1
        self.lru.pop(p, None)         # referenced again: not reclaimable

    def unref_page(self, p):
        self.page_ref[p] -= 1
        if self.page_ref[p] > 0:
            return
        if p in self.page_key:        # content cached: park reclaimable
            self.lru[p] = None
            self.lru.move_to_end(p)
        else:
            self.free_pages.append(p)

    def alloc_page(self):
        """A writable page with refcount 1: free list first, then LRU
        eviction of the oldest cached-but-unreferenced page. Returns None
        when both are dry (the caller preempts — last resort)."""
        if _faults.active and _faults.fire("serving.page_alloc") is not None:
            return None               # injected allocation failure (dry pool)
        if self.free_pages:
            p = self.free_pages.popleft()
        elif self.lru:
            p, _ = self.lru.popitem(last=False)
            key = self.page_key.pop(p)
            self.key_page.pop(key, None)
            self.cache_evictions += 1
            if self._m is not None:
                self._m.evictions.inc()
            self._spill_or_evict(p, key)
        else:
            return None
        self.page_ref[p] = 1
        return p

    def _spill_or_evict(self, p, key):
        """Demote an LRU-reclaimed page: into the host tier when one is
        attached (the chain key survives, event "spill"), else a plain
        eviction (event "evict").  Spill failure degrades to eviction —
        correctness never depends on the copy."""
        if self.host is not None:
            if key in self.host:
                self.host.touch(key)      # already spilled: HBM copy was a
                spilled = True            # restore — the host copy stands
            else:
                blk = self.spill_page(p) if self.spill_page is not None \
                    else None
                spilled = blk is not None and self.host.put(key, blk)
            if spilled:
                if self.cache_event_listener is not None:
                    self.cache_event_listener("spill", key)
                return
        if self.cache_event_listener is not None:
            self.cache_event_listener("evict", key)

    # -------------------------------------------------------- host spill tier
    def attach_host(self, store: HostPageStore, bytes_per_page):
        """Wire the host-RAM tier in: LRU reclaims spill through it and its
        own evictions notify the cache-event listener (the chain is then gone
        from every tier of this replica)."""
        self.host = store
        self._host_page_bytes = int(bytes_per_page)
        store.on_evict = self._host_evicted

    def _host_evicted(self, key):
        # the host tier aged a chain key out; only announce the loss when no
        # device page still serves that key (restore re-registered it in HBM)
        if key not in self.key_page and self.cache_event_listener is not None:
            self.cache_event_listener("evict", key)

    def host_headroom_pages(self):
        """Pages the host tier could still absorb without evicting — the
        shed watermark and SLO admission count these as reclaimable-without-
        loss headroom."""
        if self.host is None or self._host_page_bytes <= 0:
            return 0
        return min(self.host.headroom_pages(self._host_page_bytes),
                   self.n_usable)

    # ----------------------------------------------------------- prefix index
    def lookup(self, key):
        """Physical page currently serving ``key``'s content, or None."""
        return self.key_page.get(key)

    def register(self, p, key):
        """Content-register page ``p`` under chain ``key``.  First
        registration wins; a page whose content another physical page
        already serves stays private.  Returns True when registered."""
        if p in self.page_key or key in self.key_page:
            return False
        self.page_key[p] = key
        self.key_page[key] = p
        if self.cache_event_listener is not None:
            self.cache_event_listener("register", key)
        return True

    def record_admission(self, n_hits, n_misses, n_host=0):
        """Admission-time hit/miss accounting (pages, not tokens).
        ``n_host`` is the subset of ``n_hits`` served by restoring spilled
        pages from the host tier rather than from resident HBM pages."""
        self.cache_hits += n_hits
        self.cache_misses += n_misses
        self.host_hits += n_host
        if self._m is not None:
            self._m.hits.inc(n_hits)
            self._m.misses.inc(n_misses)
            if n_hits - n_host:
                self._m.tier_hits_hbm.inc(n_hits - n_host)
            if n_host:
                self._m.tier_hits_host.inc(n_host)

    # ------------------------------------------------------------------ state
    @property
    def n_usable(self):
        """Pages the budget covers (the trash page excluded)."""
        return self.n_pages - 1

    def n_available(self, reserved_lru=0, host_headroom=False):
        """Pages admission could newly claim: free + reclaimable, minus LRU
        pages the caller is about to re-reference (cache hits parked in the
        LRU are NOT allocatable — they are being claimed as hits).  With
        ``host_headroom=True`` (shed-watermark accounting only), LRU pages
        the host tier could absorb count as reclaimable-without-loss."""
        avail = len(self.free_pages) + len(self.lru) - reserved_lru
        if host_headroom:
            avail += min(self.host_headroom_pages(), len(self.lru))
        return avail

    # ------------------------------------------------------------------ audit
    def audit(self, expected_refs):
        """Cross-check every page-accounting structure against the others;
        returns a list of problem strings (empty means clean).
        ``expected_refs`` is the caller-computed per-page reference count
        (slot-table references plus any in-flight handoff holds)."""
        problems = []
        free = [int(p) for p in self.free_pages]
        free_set = set(free)
        if len(free_set) != len(free):
            problems.append("free list holds duplicate pages")
        lru_set = {int(p) for p in self.lru}
        both = free_set & lru_set
        if both:
            problems.append(f"pages both free and LRU-parked: {sorted(both)}")
        for p in range(self.n_pages - 1):            # trash page excluded
            refs, exp = int(self.page_ref[p]), int(expected_refs[p])
            if refs != exp:
                problems.append(f"page {p}: refcount {refs} != "
                                f"{exp} slot-table references")
            if refs == 0 and p not in free_set and p not in lru_set:
                problems.append(f"page {p}: leaked "
                                "(refcount 0, neither free nor LRU-parked)")
            if refs > 0 and (p in free_set or p in lru_set):
                problems.append(f"page {p}: referenced but on the "
                                "free/LRU list")
        for p in lru_set:
            if p not in self.page_key:
                problems.append(f"page {p}: LRU-parked but not "
                                "content-registered")
        for p, key in self.page_key.items():
            if self.key_page.get(key) != p:
                problems.append(f"page {p}: page->key->page asymmetric")
        for key, p in self.key_page.items():
            if self.page_key.get(p) != key:
                problems.append(f"page {p}: key->page->key asymmetric")
        if self.host is not None:
            problems.extend(self.host.audit())
        return problems
