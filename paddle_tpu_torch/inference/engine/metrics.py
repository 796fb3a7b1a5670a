"""Per-engine registry bindings (label ``engine=<seq>``).

One :class:`_EngineMetrics` is built per :class:`~.core.LLMEngine`; every
series the engine touches on the hot path is resolved to a labelled child
exactly once here, so the step loop never pays a registry lookup.
"""
from __future__ import annotations

from ... import observability as _obs
from .request import TERMINAL_STATUSES

__all__ = ["_EngineMetrics", "_PoolMetrics"]


class _EngineMetrics:
    """Registry children bound once per engine (label ``engine=<seq>``).

    Every mutation is a no-op while observability is disabled, so the engine
    attributes (cache_hits, preemptions, ...) stay the always-on source of
    truth and the registry mirrors them 1:1 whenever metrics are on — the
    parity :meth:`LLMEngine.prefix_cache_stats` keeps by construction."""

    def __init__(self, label):
        e = {"engine": label}
        self.label = label
        self.ttft = _obs.SERVING_TTFT.labels(**e)
        self.token_latency = _obs.SERVING_TOKEN_LATENCY.labels(**e)
        self.queue_depth = _obs.SERVING_QUEUE_DEPTH.labels(**e)
        self.active_slots = _obs.SERVING_ACTIVE_SLOTS.labels(**e)
        self.occupancy = _obs.SERVING_OCCUPANCY.labels(**e)
        self.prefill = _obs.SERVING_DISPATCHES.labels(kind="prefill", **e)
        self.decode = _obs.SERVING_DISPATCHES.labels(kind="decode", **e)
        self.tokens = _obs.SERVING_TOKENS.labels(**e)
        self.preempt = _obs.SERVING_PREEMPTIONS.labels(**e)
        self.hits = _obs.SERVING_CACHE_EVENTS.labels(event="hit", **e)
        self.misses = _obs.SERVING_CACHE_EVENTS.labels(event="miss", **e)
        self.evictions = _obs.SERVING_CACHE_EVENTS.labels(event="eviction",
                                                          **e)
        self.cow = _obs.SERVING_CACHE_EVENTS.labels(event="cow_copy", **e)
        self.cached_pages = _obs.SERVING_CACHED_PAGES.labels(**e)
        self.reclaimable = _obs.SERVING_RECLAIMABLE_PAGES.labels(**e)
        self.free_pages = _obs.SERVING_FREE_PAGES.labels(**e)
        # KV-cache hierarchy (host spill tier + peer pulls)
        self.tier_spills = _obs.SERVING_KV_TIER_EVENTS.labels(
            event="spill", **e)
        self.tier_restores = _obs.SERVING_KV_TIER_EVENTS.labels(
            event="restore", **e)
        self.tier_peer_export = _obs.SERVING_KV_TIER_EVENTS.labels(
            event="peer_export", **e)
        self.tier_peer_import = _obs.SERVING_KV_TIER_EVENTS.labels(
            event="peer_import", **e)
        self.tier_spill_bytes = _obs.SERVING_KV_TIER_BYTES.labels(
            direction="spill", **e)
        self.tier_restore_bytes = _obs.SERVING_KV_TIER_BYTES.labels(
            direction="restore", **e)
        self.tier_peer_bytes_out = _obs.SERVING_KV_TIER_BYTES.labels(
            direction="peer_out", **e)
        self.tier_peer_bytes_in = _obs.SERVING_KV_TIER_BYTES.labels(
            direction="peer_in", **e)
        self.tier_hits_hbm = _obs.SERVING_KV_TIER_HITS.labels(
            tier="hbm", **e)
        self.tier_hits_host = _obs.SERVING_KV_TIER_HITS.labels(
            tier="host", **e)
        self.host_cached = _obs.SERVING_HOST_CACHED_PAGES.labels(**e)
        self.verify = _obs.SERVING_DISPATCHES.labels(kind="verify", **e)
        self.spec_proposed = _obs.SERVING_SPEC_PROPOSED.labels(**e)
        self.spec_accepted = _obs.SERVING_SPEC_ACCEPTED.labels(**e)
        self.spec_acceptance = _obs.SERVING_SPEC_ACCEPTANCE.labels(**e)
        self.terminal = {s: _obs.SERVING_TERMINALS.labels(status=s.value, **e)
                         for s in TERMINAL_STATUSES}
        self.step_fail = {ph: _obs.SERVING_STEP_FAILURES.labels(phase=ph, **e)
                          for ph in ("prefill", "decode", "verify")}
        self.probes = _obs.SERVING_QUARANTINE_PROBES.labels(**e)


class _PoolMetrics:
    """Registry children bound once per :class:`~.disagg.DisaggEngine`
    (label ``pool=<seq>``) — the handoff seam's queue gauge plus the
    wait/transfer histograms, split by how the block crossed (``local``:
    jitted gather → device_put; ``cross_host``: serialized over the worker
    RPC plane).  ``handoff_stats()`` mirrors the same numbers always-on."""

    def __init__(self, label):
        p = {"pool": label}
        self.label = label
        self.queue_depth = _obs.SERVING_HANDOFF_QUEUE_DEPTH.labels(**p)
        self.wait = {path: _obs.SERVING_HANDOFF_WAIT_SECONDS.labels(
            path=path, **p) for path in ("local", "cross_host")}
        self.transfer = {path: _obs.SERVING_HANDOFF_TRANSFER_SECONDS.labels(
            path=path, **p) for path in ("local", "cross_host")}
