""":class:`LLMEngine` — the engine-core facade.

The engine composes the three core components behind explicit interfaces —
:class:`~.scheduler.Scheduler` (admission, deadlines, continuous batching,
preemption), :class:`~.pages.PagePool` (paged KV accounting, refcounts,
prefix cache, CoW, rollback), :class:`~.runner.ModelRunner` (prefill /
decode forwards on one device) — and keeps the pre-split
public API byte-for-byte: the frontend, fault-tolerance, and spec-decode
layers drive it unchanged, and the legacy private attributes
(``_slots``, ``_free_pages``, ``_waiting``, ...) remain reachable through
the :class:`~.compat._LegacyDelegation` mixin.

What stays IN the facade is exactly the cross-component orchestration: the
step loop and its phase policy, step-failure isolation (transient retry →
quarantine bisection), the decode-block auto-fit, metrics, and the
streaming accessors (speculative accept/rollback rides in via
:class:`~.spec._SpecOrchestration`).  The
``prefill_sink`` hook is the disaggregation seam: when set, a request whose
prompt just finished prefilling is handed to the sink (which detaches it
for KV handoff) instead of entering this engine's decode phase — see
:class:`~.disagg.DisaggEngine`.
"""
from __future__ import annotations

import math
import time

import numpy as np

from ... import observability as _obs
from ...observability import flight as _flight
from ...core.retry import RetryError, RetryPolicy, retry_call
from ...testing.faults import FAULTS as _faults
from .compat import _LegacyDelegation
from .metrics import _EngineMetrics
from .pages import HostPageStore, PagePool
from .request import Request, RequestStatus
from .runner import _MAXK, ModelRunner
from .scheduler import Scheduler
from .spec import _SpecOrchestration

__all__ = ["LLMEngine"]


class _TransientStep(Exception):
    """Private wrapper around a transient step error so :func:`retry_call`
    retries exactly those — any non-transient error escapes the retry loop
    unwrapped and falls through to quarantine isolation."""

    def __init__(self, err):
        super().__init__(str(err))
        self.err = err


class _TransientTier(Exception):
    """Private wrapper around a transient KV-tier error (``kv.spill`` /
    ``kv.restore`` fault points) so :func:`retry_call` retries exactly
    those; a poison (non-transient) error escapes the retry loop and the
    tier operation degrades to its lossless fallback — eviction on spill,
    recompute on restore."""

    def __init__(self, err):
        super().__init__(str(err))
        self.err = err


class LLMEngine(_LegacyDelegation, _SpecOrchestration):
    """Continuous-batching paged-KV engine over a LlamaForCausalLM.

    The pre-split private-attribute surface comes from
    :class:`~.compat._LegacyDelegation`; the speculative-decode
    orchestration from :class:`~.spec._SpecOrchestration`."""

    _engine_seq = 0   # observability label: one series set per engine

    def __init__(self, model, mesh=None, max_batch=4, max_len=256,
                 page_size=16, prefill_chunk=32, page_pool=None,
                 decode_block=1, seed=0, kv_cache_dtype="auto",
                 decode_block_max=32, prefix_cache=False, spec_decode=None,
                 max_waiting=None, shed_min_free_ratio=0.0,
                 default_deadline=None, step_retry=None,
                 debug_refcount_audit=False, host_cache_bytes=None,
                 device="cuda"):
        """device: where the weights, the KV cache and every dispatch live
        (default the card; raises without CUDA unless ``device="cpu"``).
        On CUDA, attention runs the hand-written paged-attention kernels
        (K5, K6 with int8 pages, K7 / K7q for speculative verification); on
        the CPU, their plain PyTorch versions.

        mesh: multi-device serving is not ported yet; any mesh raises.

        page_pool: usable KV pages (the HBM budget). Defaults to the
        worst case (max_batch * ceil(max_len/page)); set it SMALLER to
        oversubscribe — on-demand growth means slots only claim what they
        use, and a dry pool preempts the youngest slot (recompute).

        prefix_cache: automatic prefix caching (vLLM shared pages + CoW,
        SGLang-style chain-hash lookup). Full prompt pages are hashed by
        (prefix chain, page tokens) and refcounted; a later request whose
        prompt starts with a cached page chain maps those physical pages
        into its table and skips their prefill entirely (at least the final
        prompt token always re-prefills — its logits sample the first output
        token, and when that token's page is still shared the write goes
        through a copy-on-write private page). Released-but-cached pages
        park in an LRU and are evicted only when the free list runs dry.
        Counters: ``cache_hits`` / ``cache_misses`` (pages, at admission),
        ``cache_evictions``, ``cache_cow_copies`` — see
        :meth:`prefix_cache_stats`. Token streams are byte-identical to a
        ``prefix_cache=False`` engine at the same seeds; only dispatch
        counts and TTFT change. (One caveat shared with generate(): a
        do_sample request WITHOUT a fixed seed draws from the engine's
        global seed counter, which advances once per prefill dispatch —
        fewer dispatches shift later seedless draws. Seeded and greedy
        requests are unaffected.)

        decode_block: max decode steps fused into one dispatch (power-of-two
        blocks are chosen per step, shrinking near max_new; eos-bearing
        requests force 1). Raise it when dispatch latency, not throughput,
        dominates (e.g. a remote/tunneled runtime) — or pass "auto": the
        engine then samples wall time at two block sizes, solves the
        dispatch model t(k) = RTT + k*c for the session's actual round-trip
        latency and per-token device time, and picks the power-of-two block
        where RTT costs <= ~25% of device time (re-estimated as timing
        samples accumulate, capped at decode_block_max).

        kv_cache_dtype: "auto" stores pages in the weight dtype; "int8"
        quantizes K/V pages per-(token, kv-head) with f32 scales (reference:
        incubate block_multihead_attention cache_*_quant_scales, dynamic
        mode) — pages cost (D + 4)/(2*D) of bf16 bytes (~0.52 at
        head_dim=128), so the same HBM budget holds ~2x the tokens /
        concurrent slots.

        spec_decode: a :class:`SpecConfig` enables speculative decoding —
        each step a proposer drafts up to max_draft continuation tokens per
        request (self-drafting n-gram suffix match by default, or a small
        draft model) and ONE target-model forward scores the pending token
        plus every draft at consecutive positions (multi-query paged
        attention). Acceptance is the standard token-match rule — the
        longest draft prefix that equals what the target would have
        sampled — which for the deterministic proposers here is exact
        rejection sampling, so greedy and fixed-seed sampled outputs are
        token-identical to a spec-off engine. Accepted tokens all land in
        one dispatch (up to max_draft+1 tokens/step); rejected drafts roll
        their provisional KV pages back through the page-pool refcounts
        (a partially-filled page is truncated, never shared). Steps where
        no request has a draft fall through to the normal decode-block
        path. Counters: :meth:`spec_stats`, plus ``spec_proposed_total`` /
        ``spec_accepted_total`` / acceptance histogram in the registry.

        Fault tolerance (see :meth:`health` for the counter snapshot):

        max_waiting: admission-control queue bound — add_request beyond it
        returns a request already terminal with status SHED (None keeps the
        legacy unbounded queue).
        shed_min_free_ratio: page-pressure watermark — while the backlog is
        non-empty and (free + reclaimable) pages fall below this fraction of
        the pool, new requests are shed.
        default_deadline: seconds each request may spend end-to-end unless
        add_request overrides; expiry sheds waiting requests and cleanly
        finalizes decoding ones (status TIMEOUT, partial output kept).
        step_retry: :class:`~paddle_tpu_torch.core.retry.RetryPolicy` for
        TRANSIENT step errors (an exception with a truthy ``transient``
        attribute, e.g. an injected transient fault) — the step is retried
        with backoff before failure isolation kicks in. Default: 3 attempts,
        10ms base.  Non-transient step errors never crash the loop: the
        failing dispatch is re-run one slot at a time and the slot that
        fails alone is quarantined (terminal FAILED, pages freed through the
        refcounts) while the rest keep serving.
        debug_refcount_audit: run :meth:`audit_refcounts` after every step
        and raise on any page-accounting violation (tier-1 chaos tests keep
        this on to prove no failure path leaks pages).

        host_cache_bytes: byte budget for the host-RAM KV spill tier
        (requires ``prefix_cache``).  When set, LRU reclaim and preemption
        demote page contents to host RAM (async device→host copy) instead
        of discarding them, and an admission hit against a spilled chain
        restores the pages via double-buffered host→device prefetch instead
        of re-prefilling.  The tier has its own LRU within the budget;
        every tier path is lossless-on-failure (spill failure → plain
        eviction, restore failure → recompute) and token-exact vs the
        recompute path.  Counters: :meth:`kv_tier_stats`; fault points:
        ``kv.spill`` / ``kv.restore``."""
        if mesh is not None:
            raise NotImplementedError(
                "multi-device serving (mesh=) is not ported yet")
        cfg = model.config
        self.cfg = cfg
        self.max_batch = max_batch
        self.max_len = max_len
        self.page = page_size
        self.chunk = int(prefill_chunk)
        self.pages_per_slot = math.ceil(max_len / page_size)
        if page_pool is None:
            page_pool = max_batch * self.pages_per_slot
        if page_pool < self.pages_per_slot:
            raise ValueError("page_pool must cover at least one max_len "
                             f"request ({self.pages_per_slot} pages)")
        # +1: a trash page absorbing the (masked-out) writes of inactive slots
        self.n_pages = int(page_pool) + 1
        self.trash_page = self.n_pages - 1
        self.mesh = mesh
        self.prefix_cache = bool(prefix_cache)
        self._m = _EngineMetrics(str(LLMEngine._engine_seq))
        LLMEngine._engine_seq += 1
        self.runner = ModelRunner(
            model, max_batch=max_batch, page_size=page_size,
            prefill_chunk=prefill_chunk, n_pages=self.n_pages,
            kv_cache_dtype=kv_cache_dtype, device=device)
        self.pool = PagePool(self.n_pages, prefix_cache=self.prefix_cache,
                             metrics=self._m)
        # host-RAM spill tier (HBM -> host RAM -> recompute hierarchy)
        self.host_spills = 0            # pages demoted device -> host
        self.host_spill_bytes = 0
        self.host_spill_drops = 0       # spill attempts degraded to eviction
        self.host_restores = 0          # pages promoted host -> device
        self.host_restore_bytes = 0
        self.host_restore_failures = 0  # restore attempts fallen to recompute
        self.peer_exports = 0           # pull_pages RPCs served
        self.peer_export_pages = 0
        self.peer_imports = 0           # peer page blocks spliced in
        self.peer_import_pages = 0
        self._tier_retry = RetryPolicy(max_attempts=3, base_delay=0.01,
                                       max_delay=0.25, seed=seed)
        if host_cache_bytes is not None:
            if not self.prefix_cache:
                raise ValueError("host_cache_bytes requires prefix_cache "
                                 "(spilled pages are keyed by chain hash)")
            self.pool.attach_host(HostPageStore(int(host_cache_bytes)),
                                  self.runner.kv_bytes_per_page())
            self.pool.spill_page = self._spill_page
        self.sched = Scheduler(
            self.pool, max_batch=max_batch, max_len=max_len,
            page_size=page_size, pages_per_slot=self.pages_per_slot,
            prefix_cache=self.prefix_cache, copy_page=self.runner.copy_page,
            metrics=self._m, max_waiting=max_waiting,
            shed_min_free_ratio=shed_min_free_ratio,
            restore_chain=self._restore_chain)
        self.prefill_dispatches = 0        # total prefill programs run
        self._next_rid = 0
        self._seed_counter = np.int64(seed) * 1_000_003
        self._auto_block = decode_block == "auto"
        if self._auto_block:
            self.decode_block = max(1, int(decode_block_max))
            self._block_target = 1          # sample k=1 first, then k=2
            self._block_samples: dict = {}  # k -> recent wall dts
            self._block_n = 0               # total samples recorded
        else:
            self.decode_block = max(1, int(decode_block))
        # speculative decoding (off unless spec_decode is a SpecConfig)
        self._spec = spec_decode
        if self._spec is not None:
            self._proposer = self._spec.make_proposer()
        self._spec_samples: dict = {}   # verify rows -> recent wall dts
        self._spec_accept_ema = None    # EMA of per-step acceptance ratio
        self.spec_proposed = 0          # draft tokens sent to verification
        self.spec_accepted = 0          # draft tokens that matched
        self.spec_emitted = 0           # tokens emitted by verify steps
        self.spec_dispatches = 0        # verify programs dispatched
        # fault tolerance: admission control, deadlines, failure isolation
        self.default_deadline = default_deadline
        self.debug_refcount_audit = bool(debug_refcount_audit)
        self._step_retry = (step_retry if step_retry is not None else
                            RetryPolicy(max_attempts=3, base_delay=0.01,
                                        max_delay=0.25, seed=seed))
        self._any_deadline = default_deadline is not None
        self._step_phase = ("admit", ())
        self.step_failures = 0          # step dispatches that raised
        self.step_retries = 0           # transient-path retry invocations
        self.quarantine_probes = 0      # single-slot isolation probes run
        self.resume_admissions = 0      # requests admitted with resume_tokens
        # disaggregation seam: when set, a request whose prompt just
        # finished prefilling is handed to the sink (which detaches it for
        # KV handoff) instead of decoding here — see disagg.DisaggEngine
        self.prefill_sink = None

    # ------------------------------------------------------------- scheduling
    def add_request(self, prompt_ids, max_new_tokens=16, eos_token_id=None,
                    do_sample=False, temperature=1.0, top_p=1.0, top_k=0,
                    seed=None, deadline=None, resume_tokens=None):
        """Submit a request; returns its rid.  ``deadline`` (seconds,
        default ``default_deadline``) bounds its total wall time.  Admission
        control may refuse it: the rid is still returned, but the request is
        already terminal with :attr:`RequestStatus.SHED` (check
        :meth:`status`) — malformed arguments still raise.

        ``resume_tokens``: output history already emitted by a previous
        incarnation of this request (the durable-resume path after a replica
        death).  The history counts as prefill context — it folds into the
        prompt exactly like preemption folds ``prompt0 + out``, so the first
        token generated here continues the sequence and the stream accessors
        emit only NEW tokens; ``max_new_tokens`` is the REMAINING budget.
        Warm prefix-cache pages make the re-prefill cheap.  Token-exactness
        of the continuation: greedy sampling depends only on the context,
        and a fixed ``seed`` keys the sampler identically at every position
        (the generate-parity scheme), so the token at each position is a
        pure function of (seed, context) — identical whether or not the
        request was interrupted.  Seedless ``do_sample`` draws from the
        engine's global counter and promises no cross-replica determinism."""
        n_prompt = int(np.asarray(prompt_ids).reshape(-1).shape[0])
        if n_prompt == 0:
            raise ValueError("empty prompt")
        n_prompt += len(resume_tokens) if resume_tokens is not None else 0
        if int(max_new_tokens) < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if n_prompt + int(max_new_tokens) > self.max_len:
            # admitting would silently truncate at max_len (ADVICE r3): the
            # caller must choose — raise max_len or shrink the request
            raise ValueError(
                f"prompt ({n_prompt}) + max_new_tokens ({max_new_tokens}) "
                f"> engine max_len ({self.max_len})")
        vocab = self.cfg.vocab_size
        if int(top_k) > min(_MAXK, vocab):
            raise ValueError(
                f"top_k={top_k} exceeds the engine's in-graph cap "
                f"{min(_MAXK, vocab)} (static top-k window)")
        if deadline is None:
            deadline = self.default_deadline
        r = Request(self._next_rid, prompt_ids, max_new_tokens, eos_token_id,
                    do_sample=do_sample, temperature=temperature,
                    top_p=top_p, top_k=top_k, seed=seed, deadline=deadline,
                    resume_tokens=resume_tokens)
        self._next_rid += 1
        ctx = _flight.current()
        if ctx is not None:
            # adopt the ambient trace (gateway-minted, or RPC-delivered by
            # the worker's server thread) so every scheduler phase records
            r.trace_id = ctx.trace_id
            _flight.record("queued", rid=r.rid, trace_id=r.trace_id,
                           prompt_tokens=len(r.prompt),
                           max_new=r.max_new, resumed=bool(r.resumed_from))
        if r.resumed_from:
            self.resume_admissions += 1
        if deadline is not None:
            self._any_deadline = True
        if self.sched.should_shed():
            self.sched.finalize(r, RequestStatus.SHED)
        else:
            self.sched.waiting.append(r)
        return r.rid

    def cancel(self, rid):
        """Cancel a request wherever it is: waiting (dequeued) or mid-serve
        (slot released — pages return through the refcount machinery, so
        prefix-cache pages other slots share stay live).  Returns True if
        the request was found live; False if unknown or already terminal."""
        return self.sched.cancel(rid)

    def _next_seed(self, r):
        if r.seed is not None:
            return int(r.seed)       # fixed seed: matches model.generate
        self._seed_counter += 1
        return int(self._seed_counter % (2 ** 31 - 1))

    def _prefill_chunk(self, slot):
        sched = self.sched
        r = sched.slots[slot]
        self._step_phase = ("prefill", (slot,))
        _faults.maybe_fire("serving.step", rids=[r.rid], phase="prefill")
        start = r.pos
        n = min(self.chunk, len(r.prompt) - start)
        if self.prefix_cache:
            # about to write [start, start+n): un-share any page another
            # slot still maps (a fully-cached prompt re-prefilling its
            # final token into the last shared page lands here)
            sched.cow_unshare(slot, start, n)
        toks = np.zeros((self.chunk,), np.int32)
        toks[:n] = r.prompt[start:start + n]
        finishes = (start + n) == len(r.prompt)
        r.prefill_dispatches += 1
        self.prefill_dispatches += 1
        self._m.prefill.inc()
        t0 = time.perf_counter()
        with _obs.trace_span("serving.prefill"):
            nxt = self.runner.run_prefill(
                toks, start, sched.slot_tables[slot], n,
                0 if r.do_sample else 1, r.temperature, r.top_p, r.top_k,
                self._next_seed(r))
        if r.trace_id is not None:
            _flight.record("prefill", rid=r.rid, trace_id=r.trace_id,
                           dur=time.perf_counter() - t0, tokens=n,
                           start=start)
        r.pos += n
        sched.lens[slot] = start + n
        if self.prefix_cache:
            sched.register_pages(slot, r)
        if finishes:
            token = int(nxt)
            if self.prefill_sink is not None:
                self.prefill_sink(slot, token)
            else:
                sched.emit(slot, token)

    def step(self):
        """One engine dispatch: a prefill chunk if any slot is mid-prompt,
        else one decode token for every active slot. Returns #slots served.

        This is the failure-isolation boundary: a step that raises never
        kills the engine.  Transient errors (``err.transient`` truthy) are
        retried with backoff; anything else triggers a quarantine sweep —
        the failing dispatch is re-run one slot at a time and the slot that
        still fails alone is finalized FAILED (pages freed), the rest keep
        serving.  Isolation is exact for host-side failures; a fault inside
        an already-launched kernel is best-effort (the cache may hold a
        partial write) — the engine still degrades per-request instead of
        crashing the loop."""
        if self._any_deadline:
            self.sched.expire_deadlines()
        self._step_phase = ("admit", ())
        try:
            served = self._step_impl()
        except Exception as e:  # noqa: BLE001 — the isolation boundary
            served = self._survive_step_failure(e)
        if self.debug_refcount_audit:
            problems = self.audit_refcounts()
            if problems:
                raise RuntimeError("page-refcount audit failed:\n  "
                                   + "\n  ".join(problems))
        return served

    def _step_impl(self):
        sched = self.sched
        sched.admit()
        if _obs.enabled():
            self._refresh_gauges()
        if _faults.active:
            point = _faults.fire("serving.slow_step")
            if point is not None and point.delay:
                time.sleep(point.delay)
        for slot, r in enumerate(sched.slots):
            if r is not None and r.pos < len(r.prompt):
                self._prefill_chunk(slot)
                return 1
        live = [(s, r) for s, r in enumerate(sched.slots) if r is not None]
        if not live:
            return 0
        if self._spec is not None:
            props = self._propose_drafts(live)
            if any(props.values()):
                return self._spec_step(live, props)
            # no slot has a draft this step: the plain decode block below
            # amortizes dispatch cost better than a 1-row verify would
        # block size: largest power of two <= every slot's remaining budget,
        # capped by decode_block (or the RTT-adapted target in auto mode);
        # any eos request needs per-token host inspection -> 1
        cap = self._block_target if self._auto_block else self.decode_block
        k = min(cap, min(r.max_new - len(r.out) for _, r in live))
        if any(r.eos is not None for _, r in live):
            k = 1
        k = 1 << max(0, k.bit_length() - 1)              # floor to pow2
        active = np.zeros((self.max_batch,), np.int32)
        tokens = np.zeros((self.max_batch,), np.int32)
        greedy = np.ones((self.max_batch,), np.int32)
        temp = np.ones((self.max_batch,), np.float32)
        topp = np.ones((self.max_batch,), np.float32)
        topk = np.zeros((self.max_batch,), np.int32)
        seeds = np.zeros((self.max_batch,), np.int32)
        fold = np.zeros((self.max_batch,), np.int32)
        for slot, r in live:
            if sched.slots[slot] is not r:
                continue        # preempted by an earlier slot's growth
            sched.ensure_page(slot, ahead=k)
        # growth may have preempted members of `live` — drop them before
        # building the batch (a stale entry would re-allocate pages to an
        # empty slot and decode a request that is back in the queue)
        live = [(s, r) for s, r in live if sched.slots[s] is r]
        if not live:
            return 0
        for slot, r in live:
            active[slot] = 1
            tokens[slot] = r.out[-1]
            greedy[slot] = 0 if r.do_sample else 1
            temp[slot] = r.temperature
            topp[slot] = r.top_p
            topk[slot] = r.top_k
            seeds[slot] = self._next_seed(r)
            fold[slot] = 1 if r.seed is None else 0
        self._step_phase = ("decode", tuple(s for s, _ in live))
        _faults.maybe_fire("serving.step", rids=[r.rid for _, r in live],
                           phase="decode")
        # the dispatch that captures the program (on the CPU: its first)
        compile_call = not self.runner.has_decode_program(k)
        self._m.decode.inc()
        t0 = time.perf_counter()
        with _obs.trace_span("serving.decode"):
            toks = self.runner.run_decode(
                k, tokens, sched.lens, sched.slot_tables, active,
                greedy, temp, topp, topk, seeds, fold)       # [k, B]
        dt = time.perf_counter() - t0
        if _flight.enabled():
            for slot, r in live:
                if r.trace_id is not None:
                    _flight.record("decode", rid=r.rid, trace_id=r.trace_id,
                                   dur=dt, block=k)
        if self._auto_block and not compile_call:
            # host sync above makes the wall time a true dispatch sample
            self._record_block_sample(k, dt)
        if not compile_call and _obs.enabled():
            # dispatch served k tokens for each live slot; exclude the
            # capturing call so the histogram reflects steady-state latency
            for _ in live:
                self._m.token_latency.observe(dt / k)
        for j in range(k):
            for slot, r in live:
                if sched.slots[slot] is not r:               # released mid-block
                    continue
                sched.lens[slot] += 1
                sched.emit(slot, int(toks[j, slot]))
        return len(live)

    # ----------------------------------------------------- failure isolation
    def _survive_step_failure(self, e):
        """Handle an exception that escaped :meth:`_step_impl`.  Transient
        errors re-dispatch through the shared backoff policy; everything
        else is attributed to a request and quarantined.  Returns the #slots
        the recovery path ended up serving."""
        phase, slots = self._step_phase
        if phase == "admit":
            # failed outside any dispatch — host-side bookkeeping, an
            # engine bug rather than a poison request: surface it
            raise e
        self.step_failures += 1
        self._m.step_fail[phase].inc()
        if getattr(e, "transient", False):
            ok, served, e = self._retry_step()
            if ok:
                return served
            phase, slots = self._step_phase   # the failing retry's phase
            if phase == "admit":
                raise e
        return self._isolate(phase, slots, e)

    def _retry_step(self):
        """Re-dispatch through the shared backoff policy.  Returns ``(True,
        served, None)`` when a retry lands, ``(False, 0, err)`` when the
        attempts run out — or a NON-transient error interrupts the retry
        run; either way isolation takes over from whatever phase the final
        error left in ``_step_phase``."""
        def attempt():
            try:
                return self._step_impl()
            except Exception as err:
                if getattr(err, "transient", False):
                    raise _TransientStep(err) from err
                raise

        def note(n, err, delay):
            self.step_retries += 1

        self.step_retries += 1        # the re-dispatch itself is a retry
        try:
            served = retry_call(attempt, policy=self._step_retry,
                                retry_on=(_TransientStep,),
                                op="serving.step", on_retry=note)
        except RetryError as err:
            return False, 0, err.__cause__.err
        except Exception as err:  # noqa: BLE001 — non-transient mid-retry
            return False, 0, err
        return True, served, None

    def _isolate(self, phase, slots, e):
        """Quarantine the poison request(s) behind a failed dispatch: a
        single-slot failure (prefill, or a 1-wide batch) is attributed
        directly; a batched decode/verify failure is bisected by re-running
        every member slot as a one-slot decode probe and quarantining
        exactly those that still fail alone."""
        todo = [s for s in slots if self.sched.slots[s] is not None]
        if len(todo) <= 1:
            for s in todo:
                self._quarantine(s, e)
            return 0
        served = 0
        for s in todo:
            if self.sched.slots[s] is None:
                continue          # released/preempted by an earlier probe
            self.quarantine_probes += 1
            self._m.probes.inc()
            try:
                self._decode_probe(s)
                served += 1
            except Exception as pe:  # noqa: BLE001 — probe attributes blame
                self._quarantine(s, pe)
        return served

    def _quarantine(self, slot, err):
        """Finalize the slot's request FAILED — the error is recorded on the
        request, its pages return through the refcounts (shared prefix-cache
        pages other slots map stay live) — and keep serving everyone else.
        The victim's trace is pinned in the flight recorder (and dumped when
        a dump dir is configured) so the post-mortem survives ring churn."""
        r = self.sched.slots[slot]
        if r is not None and r.trace_id is not None:
            _flight.pin(r.trace_id, "quarantine")
        self.sched.release(slot, RequestStatus.FAILED, error=err)

    def _decode_probe(self, slot):
        """One-slot k=1 decode dispatch — the isolation probe run for each
        member of a failed batch.  A raise here pins the failure on this
        slot; success emits the token the probe decoded anyway, so a
        surviving request loses no work to the sweep."""
        sched = self.sched
        r = sched.slots[slot]
        self._step_phase = ("decode", (slot,))
        _faults.maybe_fire("serving.step", rids=[r.rid], phase="decode")
        sched.ensure_page(slot, ahead=1)
        if sched.slots[slot] is not r:
            return                # growth preempted the probe target
        active = np.zeros((self.max_batch,), np.int32)
        tokens = np.zeros((self.max_batch,), np.int32)
        greedy = np.ones((self.max_batch,), np.int32)
        temp = np.ones((self.max_batch,), np.float32)
        topp = np.ones((self.max_batch,), np.float32)
        topk = np.zeros((self.max_batch,), np.int32)
        seeds = np.zeros((self.max_batch,), np.int32)
        fold = np.zeros((self.max_batch,), np.int32)
        active[slot] = 1
        tokens[slot] = r.out[-1]
        greedy[slot] = 0 if r.do_sample else 1
        temp[slot] = r.temperature
        topp[slot] = r.top_p
        topk[slot] = r.top_k
        seeds[slot] = self._next_seed(r)
        fold[slot] = 1 if r.seed is None else 0
        self._m.decode.inc()
        with _obs.trace_span("serving.decode_probe"):
            toks = self.runner.run_decode(
                1, tokens, sched.lens, sched.slot_tables, active,
                greedy, temp, topp, topk, seeds, fold)
        sched.lens[slot] += 1
        sched.emit(slot, int(toks[0, slot]))

    def audit_refcounts(self):
        """Cross-check every page-accounting structure against the others;
        returns a list of problem strings (empty means clean).  Invariants:
        each page's refcount equals its slot-table references; free and
        LRU-parked pages carry refcount 0 and never overlap; no page leaks
        (refcount 0 yet neither free nor parked); LRU pages are
        content-registered; the prefix key index is symmetric.  O(pages +
        slots·pages_per_slot); runs after every step under
        ``debug_refcount_audit``."""
        return self.pool.audit(self.sched.expected_refs(self.n_pages))

    def _record_block_sample(self, k, wall_dt):
        """Auto decode-block: least-squares fit of t(k) = RTT + k*c over
        the per-size medians of EVERY sampled block size, targeting the
        power-of-two k where per-dispatch constant costs <= ~25% of device
        time (k >= 3*RTT/c). Fitting all sizes (instead of the two
        earliest medians) lets late samples at large k keep correcting the
        model, and every 64th sample the target drops back to a small k
        for one dispatch so the intercept estimate can't go stale."""
        samples = self._block_samples.setdefault(k, [])
        samples.append(wall_dt)
        del samples[:-8]
        self._block_n += 1
        sampled = {kk: sorted(v)[len(v) // 2]
                   for kk, v in self._block_samples.items() if v}
        if len(sampled) < 2:
            # force a second sample size next step so the model is solvable
            self._block_target = min(2, self.decode_block) \
                if 1 in sampled else 1
            return
        ks = sorted(sampled)
        c, rtt = np.polyfit(np.asarray(ks, np.float64),
                            np.asarray([sampled[kk] for kk in ks],
                                       np.float64), 1)
        if c <= 0 or rtt <= 0:       # noise/local runtime: RTT negligible
            self._block_target = min(2, self.decode_block)
            return
        want = max(1, int(3 * rtt / c))
        want = 1 << (want.bit_length() - 1)              # floor to pow2
        self._block_target = min(want, self.decode_block)
        if self._block_n % 64 == 0:
            # periodic small-k re-sample refreshes the RTT intercept
            self._block_target = min(2, self.decode_block)

    @property
    def auto_decode_block(self):
        """Current RTT-adapted block target (auto mode only)."""
        return self._block_target if self._auto_block else self.decode_block

    def run_until_done(self, max_steps=10000):
        steps = 0
        while (self.sched.waiting
               or any(s is not None for s in self.sched.slots)) \
                and steps < max_steps:
            self.step()
            steps += 1
        return steps

    def _refresh_gauges(self):
        """Mirror instantaneous engine state into the registry gauges."""
        n_active = sum(1 for s in self.sched.slots if s is not None)
        self._m.queue_depth.set(len(self.sched.waiting))
        self._m.active_slots.set(n_active)
        self._m.occupancy.set(n_active / self.max_batch)
        self._m.cached_pages.set(len(self.pool.key_page))
        self._m.reclaimable.set(len(self.pool.lru))
        self._m.free_pages.set(len(self.pool.free_pages))
        if self.pool.host is not None:
            self._m.host_cached.set(len(self.pool.host))

    def metrics(self):
        """This engine's telemetry series from the process-wide registry.

        Values accumulate only while ``paddle_tpu_torch.observability.enable()``
        is on; :meth:`prefix_cache_stats` stays the always-on plain-dict
        view of the same counters."""
        if _obs.enabled():
            self._refresh_gauges()
        return _obs.snapshot(prefix="serving_",
                             labels={"engine": self._m.label})

    def prefix_cache_stats(self):
        """Counters for the automatic prefix cache (all zero when the
        `prefix_cache` knob is off).

        The same counters are exported through the observability registry
        (``serving_prefix_cache_events_total{engine=...}``); this dict is
        the always-on thin compatibility view."""
        return {
            "hits": self.pool.cache_hits,
            "misses": self.pool.cache_misses,
            "evictions": self.pool.cache_evictions,
            "cow_copies": self.pool.cache_cow_copies,
            "prefill_dispatches": self.prefill_dispatches,
            "cached_pages": len(self.pool.key_page),
            "reclaimable_pages": len(self.pool.lru),
        }

    def kv_bytes_per_page(self):
        """HBM bytes one KV page costs across all layers (both K and V,
        including int8 scales) — the unit of the page_pool budget."""
        return self.runner.kv_bytes_per_page()

    # ---------------------------------------------------------- KV tiering
    def _spill_page(self, p):
        """Device half of a host-tier spill: gather page ``p``'s contents
        into host RAM (injected into the pool as ``spill_page``).  The
        ``kv.spill`` fault point sits in front of the copy: transient
        firings retry through the tier backoff policy; a poison firing (or
        exhausted retries) returns None and the page degrades to a plain
        eviction — recompute on the next hit, never corruption."""
        def attempt():
            try:
                _faults.maybe_fire("kv.spill", page=int(p))
                return self.runner.pages_to_host([int(p)])
            except Exception as err:
                if getattr(err, "transient", False):
                    raise _TransientTier(err) from err
                raise

        try:
            blk = retry_call(attempt, policy=self._tier_retry,
                             retry_on=(_TransientTier,), op="kv.spill")
        except Exception:  # noqa: BLE001 — lossless fallback: eviction
            self.host_spill_drops += 1
            return None
        nbytes = sum(int(a.nbytes) for a in blk)
        self.host_spills += 1
        self.host_spill_bytes += nbytes
        self._m.tier_spills.inc()
        self._m.tier_spill_bytes.inc(nbytes)
        return blk

    def _restore_chain(self, keys):
        """Host half of a spill restore (injected into the scheduler as
        ``restore_chain``): bring the host-tier blocks for chain ``keys``
        back into freshly-allocated device pages via double-buffered
        host→device prefetch, and re-register them in the prefix index.
        Returns the restored physical pages IN ORDER, referenced once each
        for the caller's slot table — possibly shorter than ``keys`` (an
        aged-out entry, a dry pool, or a poison ``kv.restore`` firing);
        admission truncates its cached prefix there and the tail
        re-prefills (recompute fallback)."""
        host = self.pool.host
        if host is None:
            return []

        def attempt():
            try:
                _faults.maybe_fire("kv.restore", keys=list(keys))
            except Exception as err:
                if getattr(err, "transient", False):
                    raise _TransientTier(err) from err
                raise

        try:
            retry_call(attempt, policy=self._tier_retry,
                       retry_on=(_TransientTier,), op="kv.restore")
        except Exception:  # noqa: BLE001 — lossless fallback: recompute
            self.host_restore_failures += 1
            return []
        blocks, pages = [], []
        try:
            for key in keys:
                blk = host.get(key)
                if blk is None:
                    break
                p = self.pool.alloc_page()
                if p is None:
                    break
                blocks.append(blk)
                pages.append(p)
            if not pages:
                return []
            self.runner.restore_pages(pages, blocks)
        except Exception:  # noqa: BLE001 — unwritten pages free cleanly
            for p in pages:
                self.pool.unref_page(p)
            self.host_restore_failures += 1
            return []
        for p, key in zip(pages, keys):
            self.pool.register(p, key)
        nbytes = sum(HostPageStore.block_bytes(b) for b in blocks)
        self.host_restores += len(pages)
        self.host_restore_bytes += nbytes
        self._m.tier_restores.inc(len(pages))
        self._m.tier_restore_bytes.inc(nbytes)
        return pages

    def export_pages(self, keys):
        """Serve a peer replica's ``pull_pages`` RPC: the longest prefix of
        chain ``keys`` this engine holds in ANY tier, as one dense host
        block (HBM pages gathered in a single dispatch, host-tier entries
        read in place).  Returns ``{"keys": [...], "block": tuple of
        [L, n, page, ...] numpy arrays}``, or None when even the first key
        misses everywhere — the puller then recomputes."""
        host = self.pool.host
        served, dev, host_blocks = [], [], {}
        for i, key in enumerate(keys):
            p = self.pool.lookup(key)
            if p is not None:
                dev.append((i, int(p)))
            else:
                blk = host.get(key) if host is not None else None
                if blk is None:
                    break
                host_blocks[i] = blk
            served.append(key)
        if not served:
            return None
        dev_blk = self.runner.pages_to_host([p for _, p in dev]) \
            if dev else None
        parts = [None] * len(served)
        for j, (i, _) in enumerate(dev):
            parts[i] = tuple(a[:, j:j + 1] for a in dev_blk)
        for i, blk in host_blocks.items():
            parts[i] = blk
        n_comp = len(parts[0])
        block = tuple(np.concatenate([pk[c] for pk in parts], axis=1)
                      if len(parts) > 1 else np.ascontiguousarray(parts[0][c])
                      for c in range(n_comp))
        self.peer_exports += 1
        self.peer_export_pages += len(served)
        self._m.tier_peer_export.inc(len(served))
        self._m.tier_peer_bytes_out.inc(sum(int(a.nbytes) for a in block))
        return {"keys": served, "block": block}

    def import_pages(self, payload):
        """Splice a peer's exported page block into this engine's pool and
        prefix index (the receive half of a peer pull).  Keys already
        resident in either tier are skipped; each spliced page is
        content-registered then immediately unreferenced into the LRU
        (cached, refcount 0), so the next admission walk claims it as an
        ordinary prefix hit.  Any failure stops the splice mid-chain — the
        un-spliced tail simply recomputes.  Returns pages spliced."""
        if not payload:
            return 0
        keys, block = payload["keys"], payload["block"]
        host = self.pool.host
        n = 0
        for i, key in enumerate(keys):
            if self.pool.lookup(key) is not None \
                    or (host is not None and key in host):
                continue
            # slice the peer block BEFORE allocating: a malformed payload
            # raising here must not strand a referenced page
            blk = tuple(np.ascontiguousarray(a[:, i:i + 1]) for a in block)
            p = self.pool.alloc_page()
            if p is None:
                break
            try:
                self.runner.restore_pages([p], [blk])
            except Exception:  # noqa: BLE001 — lossless: recompute the tail
                self.pool.unref_page(p)
                break
            self.pool.register(p, key)
            self.pool.unref_page(p)      # cached, refcount 0 -> LRU parked
            n += 1
        if n:
            self.peer_imports += 1
            self.peer_import_pages += n
            self._m.tier_peer_import.inc(n)
            self._m.tier_peer_bytes_in.inc(
                sum(int(a.nbytes) for a in block) * n // max(1, len(keys)))
        return n

    def kv_tier_stats(self):
        """Counters for the KV-cache hierarchy (HBM → host RAM → peer →
        recompute); all zero when no tier knob is on.  The same counters
        are exported through the registry (``serving_kv_tier_*``)."""
        host = self.pool.host
        return {
            "host_spills": self.host_spills,
            "host_spill_bytes": self.host_spill_bytes,
            "host_spill_drops": self.host_spill_drops,
            "host_restores": self.host_restores,
            "host_restore_bytes": self.host_restore_bytes,
            "host_restore_failures": self.host_restore_failures,
            "host_cached_pages": len(host) if host is not None else 0,
            "host_bytes": host.bytes_used if host is not None else 0,
            "host_evictions": host.evictions if host is not None else 0,
            "hits_hbm": self.pool.cache_hits - self.pool.host_hits,
            "hits_host": self.pool.host_hits,
            "peer_exports": self.peer_exports,
            "peer_export_pages": self.peer_export_pages,
            "peer_imports": self.peer_imports,
            "peer_import_pages": self.peer_import_pages,
        }

    def prefix_keys(self):
        """Chain keys currently resident in the prefix cache — HBM pages
        AND host-tier spilled chains (empty when the ``prefix_cache`` knob
        is off).  The multi-process fleet snapshots this over RPC to keep
        the gateway's prefix-affinity router warm for replicas whose cache
        events it cannot observe in-process; advertising spilled chains
        lets the router score (and peers pull) prefixes this replica can
        restore without recompute."""
        keys = list(self.pool.key_page)
        if self.pool.host is not None:
            resident = self.pool.key_page
            keys.extend(k for k in self.pool.host.keys()
                        if k not in resident)
        return keys

    def result(self, rid):
        return self.sched.finished[rid].out

    def ttft(self, rid):
        """Seconds from add_request to the first generated token."""
        return self.sched.finished[rid].ttft

    def tpot(self, rid):
        """Mean seconds per output token AFTER the first (the TPOT the
        decode phase is responsible for); None while the request has not
        finished or emitted fewer than two tokens."""
        r = self._lookup(rid)
        if r.t_finish is None or r.ttft is None or len(r.out) < 2:
            return None
        return (r.t_finish - r.t_submit - r.ttft) / (len(r.out) - 1)

    def _lookup(self, rid):
        """The live or terminal :class:`Request` for ``rid`` wherever it
        is — waiting, in a slot, or finished.  KeyError when unknown."""
        return self.sched.lookup(rid)

    def new_tokens(self, rid):
        """Incremental stream accessor: the tokens ``rid`` generated since
        the previous ``new_tokens(rid)`` call (empty list when none yet).
        Output is append-only across the whole lifecycle — preemption
        re-folds the *prompt*, never the emitted stream — so concatenating
        every batch reproduces :meth:`result` exactly.  This is the public
        surface the streaming gateway reads; it never touches slot state."""
        r = self._lookup(rid)
        toks = [int(t) for t in r.out[r.stream_pos:]]
        r.stream_pos += len(toks)
        return toks

    def stream(self, rid, max_steps=100000):
        """Generator driving the engine until ``rid`` is terminal, yielding
        its tokens one by one as they are emitted (other in-flight requests
        keep being served by the same steps).  Single-caller convenience —
        a multi-replica front door runs the step loop elsewhere and polls
        :meth:`new_tokens` instead."""
        steps = 0
        while True:
            yield from self.new_tokens(rid)
            if self._lookup(rid).status.terminal:
                return
            if steps >= max_steps:
                raise RuntimeError(f"stream({rid}) exceeded {max_steps} steps")
            self.step()
            steps += 1

    def fail_all(self, error):
        """Finalize EVERY live request (waiting and running) as FAILED with
        ``error`` recorded — the front door calls this when a replica's
        step loop dies, so inflight requests end with a typed terminal
        status instead of hanging their streams forever."""
        self.sched.fail_all(error)

    def status(self, rid):
        """The request's :class:`RequestStatus` wherever it lives — waiting,
        in a slot, or terminal.  KeyError for an unknown rid."""
        return self._lookup(rid).status

    def error(self, rid):
        """The recorded ``ExceptionType: message`` string for a FAILED
        request; None for every other terminal status."""
        return self.sched.finished[rid].error

    def health(self):
        """One JSON-able liveness snapshot for external monitors — plain
        counters, available whether or not observability is enabled."""
        n_active = sum(1 for s in self.sched.slots if s is not None)
        return {
            "active_slots": n_active,
            "max_batch": self.max_batch,
            "waiting": len(self.sched.waiting),
            "finished": len(self.sched.finished),
            "free_pages": len(self.pool.free_pages),
            "reclaimable_pages": len(self.pool.lru),
            "total_pages": self.n_pages - 1,
            "host_cached_pages": (len(self.pool.host)
                                  if self.pool.host is not None else 0),
            "host_headroom_pages": self.pool.host_headroom_pages(),
            "host_bytes": (self.pool.host.bytes_used
                           if self.pool.host is not None else 0),
            "shed_requests": self.sched.shed_requests,
            "timeouts": self.sched.timeouts,
            "cancels": self.sched.cancels,
            "quarantined": self.sched.quarantined,
            "step_failures": self.step_failures,
            "step_retries": self.step_retries,
            "quarantine_probes": self.quarantine_probes,
            "resume_admissions": self.resume_admissions,
            "preemptions": self.sched.preemptions,
        }
