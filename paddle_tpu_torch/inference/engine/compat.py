"""Legacy delegation surface for the pre-split engine API.

The pre-split engine kept every structure as a private attribute; tests
and the frontend reach for them (read / in-place mutation), so the facade
forwards each name to the component that owns it now.  This mixin is pure
delegation — every property touches only ``self.sched`` / ``self.pool`` /
``self.runner``, which :class:`~.core.LLMEngine.__init__` constructs —
and exists so the facade module stays the orchestration logic alone.
"""
from __future__ import annotations

__all__ = ["_LegacyDelegation"]


class _LegacyDelegation:
    """Read (and where the old API allowed it, write) forwarding of the
    pre-split ``LLMEngine`` attribute surface onto the split components."""

    @property
    def _slots(self):
        return self.sched.slots

    @property
    def _waiting(self):
        return self.sched.waiting

    @property
    def _finished(self):
        return self.sched.finished

    @property
    def _lens(self):
        return self.sched.lens

    @property
    def _n_alloc(self):
        return self.sched.n_alloc

    @property
    def _slot_tables(self):
        return self.sched.slot_tables

    @property
    def _free_pages(self):
        return self.pool.free_pages

    @property
    def _lru(self):
        return self.pool.lru

    @property
    def _page_ref(self):
        return self.pool.page_ref

    @property
    def _page_key(self):
        return self.pool.page_key

    @property
    def _key_page(self):
        return self.pool.key_page

    @property
    def cache_hits(self):
        return self.pool.cache_hits

    @property
    def cache_misses(self):
        return self.pool.cache_misses

    @property
    def cache_evictions(self):
        return self.pool.cache_evictions

    @property
    def cache_cow_copies(self):
        return self.pool.cache_cow_copies

    @property
    def preemptions(self):
        return self.sched.preemptions

    @property
    def shed_requests(self):
        return self.sched.shed_requests

    @property
    def timeouts(self):
        return self.sched.timeouts

    @property
    def cancels(self):
        return self.sched.cancels

    @property
    def quarantined(self):
        return self.sched.quarantined

    @property
    def max_waiting(self):
        return self.sched.max_waiting

    @max_waiting.setter
    def max_waiting(self, v):
        self.sched.max_waiting = v

    @property
    def shed_min_free_ratio(self):
        return self.sched.shed_min_free_ratio

    @shed_min_free_ratio.setter
    def shed_min_free_ratio(self, v):
        self.sched.shed_min_free_ratio = v

    @property
    def cache_event_listener(self):
        return self.pool.cache_event_listener

    @cache_event_listener.setter
    def cache_event_listener(self, fn):
        self.pool.cache_event_listener = fn

    @property
    def cache(self):
        return self.runner.cache

    @cache.setter
    def cache(self, value):
        # copied in place, never rebound: the runner's captured programs
        # hold the addresses of its cache tensors (shape and dtype checked)
        self.runner.load_cache(value)

    @property
    def W(self):
        return self.runner.W

    @property
    def use_kernel(self):
        return self.runner.use_kernel

    @property
    def kv_quant(self):
        return self.runner.kv_quant

    @property
    def _decode_programs(self):
        return self.runner._decode_programs

    @property
    def _verify_programs(self):
        return self.runner._verify_programs
