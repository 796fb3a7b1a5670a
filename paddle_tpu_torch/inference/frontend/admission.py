"""SLO-aware admission control for the serving front door.

The engine already sheds at its own door (``max_waiting`` queue bound +
page-pressure watermark inside ``add_request``), but by then the request has
crossed the network, been routed, and consumed a replica's admission path.
This layer decides *before* routing, from the same signals the engine
exports — queue depth, page-pool pressure (always-on ``health()`` counters,
mirrored by the ``serving_queue_depth`` / ``serving_free_pages`` gauges) and
observed TTFT (the ``serving_ttft_seconds`` histogram, plus a local recent
window so the SLO check also works while observability is disabled).

A refusal is a typed :class:`ShedError` carrying the reason and a
``retry_after`` hint; the gateway maps it to ``429 Too Many Requests`` with
a ``Retry-After`` header, mirroring how the engine's own SHED status is
reported.
"""
from __future__ import annotations

import threading
from collections import deque

from ... import observability as _obs

__all__ = ["AdmissionDecision", "ShedError", "SLOAdmission", "AlwaysAdmit"]


class ShedError(RuntimeError):
    """Request refused before reaching a replica.  ``reason`` is the
    admission rule that fired; ``retry_after`` (seconds) is the backoff hint
    surfaced as the HTTP ``Retry-After`` header."""

    def __init__(self, reason, retry_after=1.0):
        super().__init__(f"request shed by admission control ({reason})")
        self.reason = reason
        self.retry_after = float(retry_after)

    def __reduce__(self):
        # keep reason/retry_after across pickling (the worker RPC ships
        # sheds back to the gateway as exception objects)
        return (ShedError, (self.reason, self.retry_after))


class AdmissionDecision:
    """Outcome of one admission check: ``admit`` plus, when refused, the
    rule that fired and the retry hint."""

    __slots__ = ("admit", "reason", "retry_after")

    def __init__(self, admit, reason=None, retry_after=1.0):
        self.admit = bool(admit)
        self.reason = reason
        self.retry_after = float(retry_after)

    def __repr__(self):
        return (f"AdmissionDecision(admit={self.admit}, "
                f"reason={self.reason!r})")


class AlwaysAdmit:
    """Null policy — every request passes.  The default when a ReplicaSet
    is built without an admission policy."""

    def decide(self, replicas):
        return AdmissionDecision(True)

    def observe_ttft(self, seconds):
        """Accepted and ignored — keeps the policy interface uniform."""

    def observe_tpot(self, seconds):
        """Accepted and ignored — keeps the policy interface uniform."""


class SLOAdmission:
    """Shed when serving the request would blow the SLO rather than after.

    Rules, checked in order (first refusal wins):

    ``queue_full``     every live replica's waiting queue is at
                       ``max_queue_per_replica`` — admitting only deepens
                       the backlog the engines will shed anyway.
    ``page_pressure``  even the best replica's reclaimable page ratio
                       (free + LRU-parked over total) is below
                       ``min_free_page_ratio`` while it has a backlog — new
                       prefills would immediately preempt running requests.
    ``ttft_slo``       the recent mean TTFT exceeds ``ttft_slo`` seconds.
                       Observations come from :meth:`observe_ttft` (the
                       ReplicaSet feeds finished requests' engine-measured
                       TTFT); with no local window yet the check falls back
                       to the ``serving_ttft_seconds`` histogram when
                       observability is enabled, and otherwise admits.
    ``tpot_slo``       the recent mean time-per-output-token exceeds
                       ``tpot_slo`` seconds — the decode-cadence twin of the
                       TTFT rule, so admission also backs off when decode
                       batches are saturated even while first tokens still
                       arrive on time.  Fed by :meth:`observe_tpot` (the
                       ReplicaSet reports finished requests' whole-life
                       TPOT); the no-window fallback is the
                       ``serving_token_latency_seconds`` histogram.

    All thresholds are optional; an ``SLOAdmission()`` with defaults only
    enforces the queue bound.
    """

    def __init__(self, max_queue_per_replica=64, min_free_page_ratio=0.0,
                 ttft_slo=None, tpot_slo=None, window=64, retry_after=1.0):
        self.max_queue = (None if max_queue_per_replica is None
                          else int(max_queue_per_replica))
        self.min_free_ratio = float(min_free_page_ratio)
        self.ttft_slo = None if ttft_slo is None else float(ttft_slo)
        self.tpot_slo = None if tpot_slo is None else float(tpot_slo)
        self.retry_after = float(retry_after)
        self._lock = threading.Lock()
        self._ttfts = deque(maxlen=int(window))
        self._tpots = deque(maxlen=int(window))

    def observe_ttft(self, seconds):
        """Feed one finished request's TTFT into the recent window."""
        if seconds is None:
            return
        with self._lock:
            self._ttfts.append(float(seconds))

    def observe_tpot(self, seconds):
        """Feed one finished request's per-token decode latency (its
        whole-life TPOT) into the recent window."""
        if seconds is None:
            return
        with self._lock:
            self._tpots.append(float(seconds))

    def _window_or_histogram_mean(self, window, histogram):
        with self._lock:
            if window:
                return sum(window) / len(window)
        if not _obs.enabled():
            return None
        snap = _obs.snapshot(prefix=histogram)
        series = snap.get(histogram, {}).get("series", ())
        total = sum(s["sum"] for s in series)
        count = sum(s["count"] for s in series)
        return (total / count) if count else None

    def _recent_mean_ttft(self):
        return self._window_or_histogram_mean(self._ttfts,
                                              "serving_ttft_seconds")

    def _recent_mean_tpot(self):
        return self._window_or_histogram_mean(
            self._tpots, "serving_token_latency_seconds")

    def decide(self, replicas):
        """One admission check against the live replicas' current state."""
        healths = [r.health() for r in replicas]
        if not healths:
            return AdmissionDecision(False, "no_replicas", self.retry_after)
        if self.max_queue is not None and all(
                h["waiting"] >= self.max_queue for h in healths):
            return AdmissionDecision(False, "queue_full", self.retry_after)
        if self.min_free_ratio > 0.0:
            def _ratio(h):
                # host-tier headroom counts: LRU pages a spill tier could
                # absorb are reclaimable WITHOUT recompute loss, so a
                # replica with host headroom sheds later (capped at the
                # reclaimable set — headroom beyond it frees nothing)
                total = max(1, h["total_pages"])
                headroom = min(h.get("host_headroom_pages") or 0,
                               h["reclaimable_pages"])
                return (h["free_pages"] + h["reclaimable_pages"]
                        + headroom) / total
            if all(h["waiting"] and _ratio(h) < self.min_free_ratio
                   for h in healths):
                return AdmissionDecision(False, "page_pressure",
                                         self.retry_after)
        if self.ttft_slo is not None:
            mean = self._recent_mean_ttft()
            if mean is not None and mean > self.ttft_slo:
                return AdmissionDecision(False, "ttft_slo", self.retry_after)
        if self.tpot_slo is not None:
            mean = self._recent_mean_tpot()
            if mean is not None and mean > self.tpot_slo:
                return AdmissionDecision(False, "tpot_slo", self.retry_after)
        return AdmissionDecision(True)
