"""Prefix-cache-aware request routing across engine replicas.

The serving engine keys its radix-style prefix index by chain hashes of full
KV pages (:func:`paddle_tpu_torch.inference.serving.prefix_page_keys`).  Because
the chain hash is deterministic and shared, the router can compute a
request's page keys *before* dispatch and ask: which replica already holds
the longest prefix of those pages?  Routing there turns the replica's cached
pages into skipped prefill work.

The router keeps a radix-style NODE index shared across replicas: because a
chain key already encodes its whole prefix (key_i hashes key_{i-1}), the
radix trie collapses to one dict ``chain key -> set of replicas holding that
node`` — the same collapse the engine applies to its own prefix index.  The
index is maintained from the engine's own cache events (``register`` when a
page enters the index, ``evict`` when the LRU reclaims it) —
:class:`~.replica.EngineReplica` subscribes the engine's
``cache_event_listener`` hook to :meth:`PrefixAffinityRouter.note_event`, so
the mirror can never drift from the real index except by the events in
flight during a step (self-correcting on the next event).

Scoring walks the request's chain ONCE, intersecting the per-node holder
sets — replicas drop out at the depth where their cache diverges, so the
walk is O(prompt pages) with early exit, independent of replica count
(the old per-replica probe loop re-walked the chain R times).  Scoring is
``(longest contiguous prefix-page overlap, -load, name)``: the deepest
cached prefix wins, load breaks overlap ties, and the replica name breaks
exact ties so routing is deterministic under equal state.  With zero
overlap everywhere the router degrades to least-loaded.
"""
from __future__ import annotations

import threading

from ... import observability as _obs
from ..serving import prefix_page_keys

__all__ = ["RouteDecision", "PrefixAffinityRouter", "RoundRobinRouter"]


class RouteDecision:
    """Outcome of one routing call: the chosen replica, why it won
    (``affinity`` | ``least_loaded`` | ``round_robin``), and how many
    contiguous prefix pages it already caches.  When load skew overrode
    affinity (``max_load_skew``), ``holder`` names the passed-over
    deepest-overlap replica and ``holder_overlap`` its depth — the peer
    KV-pull seam: the chosen replica can cold-pull the holder's pages."""

    __slots__ = ("replica", "reason", "overlap", "holder", "holder_overlap")

    def __init__(self, replica, reason, overlap=0, holder=None,
                 holder_overlap=0):
        self.replica = replica
        self.reason = reason
        self.overlap = int(overlap)
        self.holder = holder
        self.holder_overlap = int(holder_overlap)

    def __repr__(self):
        return (f"RouteDecision({getattr(self.replica, 'name', self.replica)!r},"
                f" {self.reason!r}, overlap={self.overlap})")


class PrefixAffinityRouter:
    """Route to the replica whose prefix cache holds the deepest prefix of
    the request; fall back to least-loaded.  Thread-safe: ``note_event``
    arrives from replica step threads while ``route`` runs on gateway
    threads."""

    def __init__(self, page_size, max_load_skew=None):
        """``max_load_skew``: load-balance override for affinity wins.  By
        default the deepest cached prefix always wins; with a skew bound,
        when the affinity winner's load exceeds the least-loaded replica's
        by MORE than ``max_load_skew``, the least-loaded replica is chosen
        instead and the affinity winner is exposed as
        :attr:`RouteDecision.holder` so the caller can cold-pull its pages
        (the peer KV tier)."""
        self.page = int(page_size)
        self.max_load_skew = max_load_skew
        self._lock = threading.Lock()
        # radix node index: a chain key names a whole prefix, so the trie
        # is one flat dict of nodes with the set of replicas holding each
        self._nodes = {}         # chain key -> set of replica names
        self._by_replica = {}    # replica name -> set of live chain keys

    # ---- index maintenance (driven by engine cache events) ------------------
    def note_event(self, replica_name, event, key):
        """Mirror one engine cache event into the node index.  ``register``
        adds the replica to the key's node, ``evict`` drops it; unknown
        events are ignored so the listener contract stays
        forward-compatible."""
        with self._lock:
            keys = self._by_replica.setdefault(replica_name, set())
            if event == "register":
                keys.add(key)
                self._nodes.setdefault(key, set()).add(replica_name)
            elif event == "evict":
                keys.discard(key)
                holders = self._nodes.get(key)
                if holders is not None:
                    holders.discard(replica_name)
                    if not holders:
                        del self._nodes[key]

    def forget(self, replica_name):
        """Drop a replica's whole index (its pages died with it)."""
        with self._lock:
            for key in self._by_replica.pop(replica_name, ()):
                holders = self._nodes.get(key)
                if holders is not None:
                    holders.discard(replica_name)
                    if not holders:
                        del self._nodes[key]

    def known_keys(self, replica_name):
        """Snapshot of the chain keys mirrored for one replica."""
        with self._lock:
            return frozenset(self._by_replica.get(replica_name, ()))

    # ---- scoring -------------------------------------------------------------
    def overlap(self, replica_name, chain_keys):
        """Longest *contiguous* prefix of ``chain_keys`` present in the
        replica's index.  Contiguity matters: chain key i is only reusable
        when pages 0..i-1 are too, exactly like the engine's admission walk."""
        with self._lock:
            n = 0
            for k in chain_keys:
                holders = self._nodes.get(k)
                if holders is None or replica_name not in holders:
                    break
                n += 1
            return n

    def _overlaps(self, chain_keys, names):
        """One walk down the request's chain: at each node, replicas not
        holding it drop out, and survivors' overlap deepens.  Early exit
        when nobody survives — O(prompt pages), not O(replicas × pages)."""
        overlaps = dict.fromkeys(names, 0)
        with self._lock:
            alive = set(names)
            for k in chain_keys:
                alive &= self._nodes.get(k, frozenset())
                if not alive:
                    break
                for name in alive:
                    overlaps[name] += 1
        return overlaps

    def route(self, prompt_ids, replicas):
        """Pick a replica for ``prompt_ids`` among ``replicas`` (objects with
        ``.name`` and ``.load()``).  Deterministic: equal (overlap, load)
        resolves by replica name."""
        if not replicas:
            raise ValueError("no replicas to route to")
        chain = prefix_page_keys(prompt_ids, self.page)
        overlaps = self._overlaps(chain, [r.name for r in replicas])
        loads = {r.name: r.load() for r in replicas}
        scored = sorted(
            ((-overlaps[r.name], loads[r.name], r.name, r) for r in replicas),
            key=lambda t: t[:3])
        neg_overlap, best_load, _, best = scored[0]
        if neg_overlap < 0:
            if self.max_load_skew is not None:
                coldest = min(replicas,
                              key=lambda r: (loads[r.name], r.name))
                if coldest is not best and \
                        best_load - loads[coldest.name] > self.max_load_skew:
                    # the cache holder is too hot: route to the coldest
                    # replica and expose the holder for a peer page pull
                    _obs.FRONTEND_AFFINITY.inc(event="skew_override")
                    return RouteDecision(
                        coldest, "least_loaded",
                        overlap=overlaps[coldest.name], holder=best,
                        holder_overlap=-neg_overlap)
            _obs.FRONTEND_AFFINITY.inc(event="hit")
            return RouteDecision(best, "affinity", overlap=-neg_overlap)
        _obs.FRONTEND_AFFINITY.inc(event="miss")
        return RouteDecision(best, "least_loaded", overlap=0)


class RoundRobinRouter:
    """Affinity-blind baseline: cycle through the replica list in order.
    Used by the bench comparison and as the control in the affinity tests."""

    def __init__(self):
        self._lock = threading.Lock()
        self._i = 0

    def note_event(self, replica_name, event, key):
        """Accepted and ignored — keeps the router interface uniform."""

    def forget(self, replica_name):
        """Accepted and ignored — keeps the router interface uniform."""

    def route(self, prompt_ids, replicas):
        if not replicas:
            raise ValueError("no replicas to route to")
        with self._lock:
            r = replicas[self._i % len(replicas)]
            self._i += 1
        return RouteDecision(r, "round_robin")
