"""paddle_tpu_torch.observability — unified runtime telemetry.

The reference ships a whole observability layer (python/paddle/profiler/
profiler.py:358: chrome-trace export, operator/memory summaries); this package
is its serving-era counterpart: ONE process-wide metrics registry plus span
tracing, threaded through dispatch, jit capture, the serving engine, and the
collective plane.

Usage::

    from paddle_tpu_torch import observability as obs

    obs.enable()                      # flips the process-wide switch
    ... run work ...
    snap = obs.snapshot()             # JSON-able dict
    text = obs.render_prometheus()    # Prometheus text exposition
    with obs.trace_span("my.phase"):  # record_function + span histogram
        ...
    obs.disable()

Cost model: disabled (the default), every instrumented call site pays one
global-bool check, and dispatch (``core/dispatch.py``) one recorder-slot
check.  ``enable()`` installs the dispatch recorder in that slot, which feeds
the ``dispatch_*`` families: one op count and host-seconds observation a
dispatch, ``taped`` when an input required grad (autocast and capture lifts
stay 0: neither is ported).

Standard metric families are declared here, in one place, so instrumented
modules share names and label schemas instead of inventing their own.
"""
from __future__ import annotations

from . import flight  # noqa: F401  (request tracing / flight recorder)
from . import registry as _registry
from .registry import (DEFAULT_BUCKETS, REGISTRY, MetricsRegistry,  # noqa: F401
                       enabled, merge_snapshots, render_snapshot)
from .tracing import SPAN_SECONDS, trace_span  # noqa: F401

__all__ = [
    "MetricsRegistry", "REGISTRY", "DEFAULT_BUCKETS",
    "enable", "disable", "enabled", "reset",
    "snapshot", "render_prometheus", "render_snapshot", "merge_snapshots",
    "trace_span", "record_collective", "start_metrics_server", "flight",
]


def start_metrics_server(port: int = 0, addr: str = "127.0.0.1"):
    """Serve :func:`render_prometheus` at ``http://addr:port/metrics`` (the
    standard scrape interface); see :mod:`.exporter`.  Lazy so importing the
    package never pays for http.server."""
    from .exporter import start_metrics_server as _start
    return _start(port=port, addr=addr)

# ---- standard families -------------------------------------------------------
# dispatch (core/dispatch.py, fed through the op_recorder slot)
DISPATCH_OPS = REGISTRY.counter(
    "dispatch_ops_total", "ops dispatched through apply_op", ("op",))
DISPATCH_AUTOCAST = REGISTRY.counter(
    "dispatch_autocast_total", "dispatches with AMP autocast active")
DISPATCH_TAPED = REGISTRY.counter(
    "dispatch_taped_total", "dispatches that recorded a vjp tape node")
DISPATCH_LIFTS = REGISTRY.counter(
    "dispatch_trace_lifted_total",
    "dispatches under an active trace context (program-capture lifts)")
DISPATCH_SECONDS = REGISTRY.histogram(
    "dispatch_host_seconds", "host wall time per op dispatch")

# jit program capture (jit/to_static.py)
JIT_EVENTS = REGISTRY.counter(
    "jit_events_total",
    "to_static lifecycle events (capture/cache_hit/retrace/"
    "guard_divergence/eager_call/echo_mismatch)", ("event", "fn"))

# serving engine (inference/serving.py); one label per engine instance
SERVING_TTFT = REGISTRY.histogram(
    "serving_ttft_seconds", "submit-to-first-token latency", ("engine",))
SERVING_TOKEN_LATENCY = REGISTRY.histogram(
    "serving_token_latency_seconds",
    "per-token decode latency (dispatch wall / block size)", ("engine",))
SERVING_QUEUE_DEPTH = REGISTRY.gauge(
    "serving_queue_depth", "requests waiting for admission", ("engine",))
SERVING_ACTIVE_SLOTS = REGISTRY.gauge(
    "serving_active_slots", "slots holding an admitted request", ("engine",))
SERVING_OCCUPANCY = REGISTRY.gauge(
    "serving_batch_occupancy_ratio", "active slots / max_batch", ("engine",))
SERVING_DISPATCHES = REGISTRY.counter(
    "serving_dispatches_total", "engine programs dispatched",
    ("engine", "kind"))                        # kind: prefill | decode | verify
SERVING_TOKENS = REGISTRY.counter(
    "serving_generated_tokens_total", "tokens emitted to requests",
    ("engine",))
SERVING_PREEMPTIONS = REGISTRY.counter(
    "serving_preemptions_total", "slots preempted back to the queue",
    ("engine",))
SERVING_CACHE_EVENTS = REGISTRY.counter(
    "serving_prefix_cache_events_total",
    "prefix-cache page events (hit/miss/eviction/cow_copy)",
    ("engine", "event"))
SERVING_CACHED_PAGES = REGISTRY.gauge(
    "serving_prefix_cached_pages", "pages registered in the prefix index",
    ("engine",))
SERVING_RECLAIMABLE_PAGES = REGISTRY.gauge(
    "serving_prefix_reclaimable_pages",
    "cached-but-unreferenced pages parked in the LRU", ("engine",))
SERVING_FREE_PAGES = REGISTRY.gauge(
    "serving_free_pages", "pages on the free list", ("engine",))
SERVING_SPEC_PROPOSED = REGISTRY.counter(
    "serving_spec_proposed_total",
    "draft tokens proposed by speculative decoding", ("engine",))
SERVING_SPEC_ACCEPTED = REGISTRY.counter(
    "serving_spec_accepted_total",
    "draft tokens accepted by in-graph verification", ("engine",))
SERVING_SPEC_ACCEPTANCE = REGISTRY.histogram(
    "serving_spec_acceptance_ratio",
    "per-verify-step accepted/proposed draft ratio", ("engine",),
    buckets=(0.0, 0.25, 0.5, 0.75, 0.9, 1.0))

# KV-cache hierarchy (HBM -> host RAM -> peer replica -> recompute)
SERVING_KV_TIER_EVENTS = REGISTRY.counter(
    "serving_kv_tier_events_total",
    "KV tier page movements (spill/restore/peer_export/peer_import)",
    ("engine", "event"))
SERVING_KV_TIER_BYTES = REGISTRY.counter(
    "serving_kv_tier_bytes_total",
    "KV bytes moved between tiers, by direction "
    "(spill/restore/peer_out/peer_in)", ("engine", "direction"))
SERVING_KV_TIER_HITS = REGISTRY.counter(
    "serving_kv_tier_hits_total",
    "admission prefix-cache page hits by serving tier (hbm/host)",
    ("engine", "tier"))
SERVING_HOST_CACHED_PAGES = REGISTRY.gauge(
    "serving_host_cached_pages",
    "KV pages resident in the host-RAM spill tier", ("engine",))

# disaggregated prefill/decode (inference/engine/disagg.py); pool labels the
# DisaggEngine instance, path says how the KV block crossed the seam
SERVING_HANDOFF_QUEUE_DEPTH = REGISTRY.gauge(
    "serving_handoff_queue_depth",
    "prefill→decode handoffs waiting in the pool's bounded queue", ("pool",))
SERVING_HANDOFF_WAIT_SECONDS = REGISTRY.histogram(
    "serving_handoff_wait_seconds",
    "queue wait from prefill completion to transfer dispatch",
    ("pool", "path"),                          # path: local | cross_host
    buckets=(0.0001, 0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0))
SERVING_HANDOFF_TRANSFER_SECONDS = REGISTRY.histogram(
    "serving_handoff_transfer_seconds",
    "wall time a KV handoff spent in transfer work the decode loop could "
    "not overlap (async: dispatch+land; sync: the whole blocking hop)",
    ("pool", "path"),
    buckets=(0.0001, 0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0))

SERVING_TERMINALS = REGISTRY.counter(
    "serving_terminal_requests_total",
    "requests reaching a typed terminal status "
    "(finished/eos/timeout/cancelled/shed/failed)", ("engine", "status"))
SERVING_STEP_FAILURES = REGISTRY.counter(
    "serving_step_failures_total",
    "engine step dispatches that raised (pre-isolation)",
    ("engine", "phase"))                       # phase: prefill | decode | verify
SERVING_QUARANTINE_PROBES = REGISTRY.counter(
    "serving_quarantine_probes_total",
    "single-slot isolation probes dispatched after a batched-step failure",
    ("engine",))

# serving front door (inference/frontend/); replica labels name the engine
# replica a request was routed to, reason says why the router picked it
FRONTEND_REQUESTS = REGISTRY.counter(
    "frontend_requests_total",
    "gateway requests by terminal outcome "
    "(finished/eos/timeout/cancelled/shed/failed)", ("outcome",))
FRONTEND_ROUTED = REGISTRY.counter(
    "frontend_routed_total",
    "requests dispatched to a replica, by routing reason "
    "(affinity/least_loaded/round_robin)", ("replica", "reason"))
FRONTEND_AFFINITY = REGISTRY.counter(
    "frontend_affinity_events_total",
    "router prefix-affinity decisions (hit: scored prefix overlap won; "
    "miss: no replica held any prefix page)", ("event",))
FRONTEND_SHED = REGISTRY.counter(
    "frontend_shed_total",
    "requests rejected before reaching a replica, by admission reason",
    ("reason",))
FRONTEND_INFLIGHT = REGISTRY.gauge(
    "frontend_inflight_requests",
    "requests admitted by the gateway and not yet terminal")
FRONTEND_STREAM_SECONDS = REGISTRY.histogram(
    "frontend_stream_seconds",
    "submit-to-terminal wall time per gateway request")

# membership plane (distributed/membership.py); group labels the fleet
MEMBERSHIP_LEASE_EXPIRIES = REGISTRY.counter(
    "membership_lease_expiries_total",
    "member leases a watcher declared expired (missed heartbeats)",
    ("group",))
MEMBERSHIP_EVENTS = REGISTRY.counter(
    "membership_events_total",
    "membership transitions observed by watchers (join/leave/expire)",
    ("group", "kind"))
MEMBERSHIP_HEARTBEAT_SECONDS = REGISTRY.histogram(
    "membership_heartbeat_seconds",
    "wall time of one lease renewal (store round-trip incl. retries)",
    ("group",),
    buckets=(0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0))

# self-healing fleet (inference/frontend/ supervisor + requeue path)
FRONTEND_RESTARTS = REGISTRY.counter(
    "frontend_replica_restarts_total",
    "worker processes respawned by the supervisor after a crash",
    ("replica",))
FRONTEND_QUARANTINES = REGISTRY.counter(
    "frontend_replica_quarantines_total",
    "replicas the crash-loop circuit breaker stopped respawning (alert!)",
    ("replica",))
FRONTEND_REQUEUED = REGISTRY.counter(
    "frontend_requeued_total",
    "inflight requests transparently re-enqueued onto a surviving replica "
    "after their replica died before streaming any token")
FRONTEND_RESUMED = REGISTRY.counter(
    "frontend_resumed_total",
    "partially-streamed requests resumed token-exact on a surviving "
    "replica (re-prefill of prompt + emitted history) after their replica "
    "died mid-stream")
FRONTEND_SPLICE_SECONDS = REGISTRY.histogram(
    "frontend_resume_splice_seconds",
    "replica-death detection to the first post-resume token — the stall a "
    "streaming client rides through a crash",
    buckets=(0.01, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0))
FRONTEND_STUCK_STEPS = REGISTRY.counter(
    "frontend_stuck_steps_total",
    "replica steps the wall-clock watchdog declared wedged (gray failure "
    "promoted to a typed replica death)", ("replica",))
FRONTEND_PEER_PULLS = REGISTRY.counter(
    "frontend_peer_pulls_total",
    "peer-replica KV page pulls before prefill, by outcome "
    "(ok: pages spliced; miss: holder no longer had the chain; "
    "failed: RPC/fault — recompute fallback)", ("outcome",))

# metrics federation (gateway /metrics scraping live fleet members)
FRONTEND_FEDERATION_ERRORS = REGISTRY.counter(
    "frontend_federation_errors_total",
    "fleet members whose metrics/trace scrape FAILED (wedged past the "
    "scrape deadline, or died mid-scrape); members already known dead are "
    "not re-counted per scrape", ("replica",))
FRONTEND_FEDERATION_SKIPPED = REGISTRY.gauge(
    "frontend_federation_skipped",
    "fleet members skipped on the last federation scrape because they "
    "were already known dead (their failure was counted once, when "
    "detected)")

# durable request plane (inference/frontend/journal.py + gateway)
JOURNAL_APPEND_SECONDS = REGISTRY.histogram(
    "journal_append_seconds",
    "wall time of one request-journal append (incl. any fsync)",
    buckets=(0.0001, 0.0005, 0.001, 0.005, 0.01, 0.05, 0.1, 0.5))
JOURNAL_REPLAYED = REGISTRY.counter(
    "journal_replayed_total",
    "journal records consumed during crash recovery, by record kind "
    "(accepted/tokens/terminal/result)", ("kind",))
GATEWAY_RECOVERIES = REGISTRY.counter(
    "gateway_recoveries_total",
    "gateway restarts that replayed a non-empty request journal")
STREAM_REATTACH = REGISTRY.counter(
    "stream_reattach_total",
    "SSE clients that reconnected with Last-Event-ID and were spliced "
    "back onto a journaled stream")

# shared retry helper (core/retry.py); op labels the retried operation
RETRY_ATTEMPTS = REGISTRY.histogram(
    "retry_attempts", "attempts consumed per retried operation", ("op",),
    buckets=(1.0, 2.0, 3.0, 5.0, 8.0, 13.0))
RETRY_EXHAUSTED = REGISTRY.counter(
    "retry_exhausted_total", "retried operations that ran out of attempts",
    ("op",))

# collective watchdog (distributed/watchdog.py)
COMM_WATCHDOG_TIMEOUTS = REGISTRY.counter(
    "comm_watchdog_timeouts_total",
    "collectives the watchdog declared timed out (probable hangs)", ("op",))

# collective plane (distributed/collective.py + parallel/ layers)
COLLECTIVE_CALLS = REGISTRY.counter(
    "collective_invocations_total",
    "explicit eager collectives invoked", ("collective",))
COLLECTIVE_BYTES = REGISTRY.counter(
    "collective_payload_bytes_total",
    "payload bytes moved by explicit eager collectives", ("collective",))
COLLECTIVE_TRACED = REGISTRY.counter(
    "collective_traced_total",
    "in-mesh collectives captured at trace time (ticks once per compiled "
    "program, not per device execution)", ("collective",))
COLLECTIVE_TRACED_BYTES = REGISTRY.counter(
    "collective_traced_payload_bytes_total",
    "per-shard payload bytes of traced in-mesh collectives", ("collective",))


# ---- dispatch recorder -------------------------------------------------------
class _DispatchRecorder:
    """Lives in core.dispatch's single ``op_recorder`` slot while metrics are
    on, so apply_op keeps exactly one instrumentation branch."""

    __slots__ = ()

    def record(self, name, dt, amp=False, taped=False, lifted=False):
        DISPATCH_OPS.inc(op=name)
        DISPATCH_SECONDS.observe(dt)
        if amp:
            DISPATCH_AUTOCAST.inc()
        if taped:
            DISPATCH_TAPED.inc()
        if lifted:
            DISPATCH_LIFTS.inc()


_DISPATCH_RECORDER = _DispatchRecorder()


def enable() -> None:
    """Flip the process-wide telemetry switch on and install the dispatch
    recorder (threads pick it up on their next dispatch-state access)."""
    from ..core import dispatch as _dispatch
    _registry._set_enabled(True)
    _dispatch.set_metrics_recorder(_DISPATCH_RECORDER)


def disable() -> None:
    """Switch telemetry off; dispatch returns to its zero-cost fast path."""
    from ..core import dispatch as _dispatch
    _dispatch.set_metrics_recorder(None)
    _registry._set_enabled(False)


def reset() -> None:
    """Zero every series in place (bound children stay valid); the
    enable/disable switch is left untouched."""
    REGISTRY.reset()


def snapshot(prefix=None, labels=None) -> dict:
    """JSON-able dump of the default registry (see
    :meth:`MetricsRegistry.snapshot` for the filters)."""
    return REGISTRY.snapshot(prefix=prefix, labels=labels)


def render_prometheus() -> str:
    """Prometheus text exposition of the default registry."""
    return REGISTRY.render_prometheus()


def record_collective(name, payload=None, traced=True, nbytes=None) -> None:
    """Count one collective invocation, with payload bytes when derivable.

    traced=True: the call site sits inside a traced program (shard_map body),
    so the count ticks once per trace and bytes are the per-shard aval size.
    ``payload`` may be an array/tracer or None; pass ``nbytes`` to override.
    Bytes are the payload tensor's ``numel() * element_size()``.
    """
    if not _registry._ENABLED:
        return
    calls, by = ((COLLECTIVE_TRACED, COLLECTIVE_TRACED_BYTES) if traced
                 else (COLLECTIVE_CALLS, COLLECTIVE_BYTES))
    calls.inc(collective=name)
    if nbytes is None and payload is not None:
        try:
            nbytes = int(payload.numel()) * payload.element_size()
        except (AttributeError, TypeError):
            nbytes = None
    if nbytes:
        by.inc(int(nbytes), collective=name)
