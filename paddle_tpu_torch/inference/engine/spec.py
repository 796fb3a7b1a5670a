"""Speculative decoding: drafting, verification orchestration, auto-fit.

Verification itself is a :class:`~.runner.ModelRunner` program
(``run_verify``); this module holds everything speculative around it —
the draft side (config + the self-drafting n-gram / small-draft-model
proposers behind one ``propose(tokens, k)`` interface) and the
:class:`_SpecOrchestration` mixin :class:`~.core.LLMEngine` inherits
(propose → single multi-query verify dispatch → accept-longest-prefix →
paged-KV rollback, plus the adaptive draft-length cost fit).
"""
from __future__ import annotations

import time

import numpy as np
import torch

from ... import observability as _obs
from ...testing.faults import FAULTS as _faults

__all__ = ["SpecConfig"]


def ceil_pow2(n):
    return 1 << max(0, int(n) - 1).bit_length() if n > 1 else 1


class SpecConfig:
    """Speculative-decoding knob (``LLMEngine(spec_decode=SpecConfig())``).

    max_draft: most draft tokens proposed per request per verify step.
    ngram_max / ngram_min: window bounds for the self-drafting n-gram
        proposer — the request's current n-token suffix (longest n first)
        is matched against its own earlier prompt+generated tokens, and
        the tokens that followed the most recent match become the draft.
        Free (no extra weights); wins on repetitive structure (code,
        retrieved context, templated text).
    draft_model: optional small LlamaForCausalLM replacing the n-gram
        proposer — greedy continuation of the request's token history.
    adaptive: learn the verify dispatch's cost curve t(rows) = RTT+rows*c
        (separately from the decode-block auto-fit: a verify step consumes
        a VARIABLE number of tokens) and pick the draft length maximizing
        expected accepted tokens per second under the observed acceptance
        rate; False always proposes max_draft."""

    def __init__(self, max_draft=4, ngram_max=3, ngram_min=1,
                 draft_model=None, adaptive=True):
        if int(max_draft) < 1:
            raise ValueError("max_draft must be >= 1")
        if int(ngram_min) < 1 or int(ngram_max) < int(ngram_min):
            raise ValueError("need 1 <= ngram_min <= ngram_max")
        self.max_draft = int(max_draft)
        self.ngram_max = int(ngram_max)
        self.ngram_min = int(ngram_min)
        self.draft_model = draft_model
        self.adaptive = bool(adaptive)

    def make_proposer(self):
        return (_DraftModelProposer(self.draft_model)
                if self.draft_model is not None else _NgramProposer(self))


class _NgramProposer:
    """Self-drafting proposer: find the most recent earlier occurrence of
    the sequence's current suffix (longest n in [ngram_min, ngram_max]
    wins) and propose the tokens that followed that occurrence."""

    def __init__(self, cfg):
        self.cfg = cfg

    def propose(self, tokens, k):
        n_tok = len(tokens)
        hi = min(self.cfg.ngram_max, n_tok - 1)
        for n in range(hi, self.cfg.ngram_min - 1, -1):
            suffix = tokens[n_tok - n:]
            for i in range(n_tok - n - 1, -1, -1):
                if tokens[i:i + n] == suffix:
                    cont = tokens[i + n:i + n + k]
                    if cont:
                        return list(cont)
        return []


class _DraftModelProposer:
    """Draft-model proposer: greedy continuation from a small model. The
    draft recomputes from the full token history each call (no persistent
    draft KV) — drafts are short and the draft model is small, so clarity
    beats cache bookkeeping here."""

    def __init__(self, model):
        self.model = model

    def propose(self, tokens, k):
        ids = torch.as_tensor(np.asarray([tokens], np.int64),
                              device=self.model.device)
        out = self.model.generate(ids, max_new_tokens=k, do_sample=False)
        return [int(t) for t in out[0, len(tokens):].tolist()]


class _SpecOrchestration:
    """Speculative-decode orchestration mixed into
    :class:`~.core.LLMEngine` — every attribute referenced here
    (``self.runner`` / ``self.sched`` / ``self._m`` / the ``spec_*``
    counters / ``self._spec`` / ``self._proposer``) is constructed by the
    engine's ``__init__``; the mixin imports no sibling module, so the
    package layering guard stays acyclic."""

    def _propose_drafts(self, live):
        """Draft continuation tokens per live slot, capped so that drafts+1
        emitted tokens can neither exceed the request's remaining budget nor
        run past max_len."""
        props = {}
        target = self._spec_draft_target()
        for slot, r in live:
            cap = min(target, r.max_new - len(r.out) - 1,
                      self.max_len - int(self.sched.lens[slot]) - 1)
            if cap < 1:
                props[slot] = []
                continue
            # full token history (prompt0+out survives preemption re-folds)
            props[slot] = self._proposer.propose(r.prompt0 + r.out, cap)[:cap]
        return props

    def _spec_step(self, live, props):
        """One speculative step: verify every live slot's pending token plus
        its drafts in a single multi-query dispatch, emit the accepted run,
        roll rejected pages back. Slots without a proposal ride along with
        one row (their pending token advances normally)."""
        sched = self.sched
        for slot, r in live:
            if sched.slots[slot] is not r:
                continue        # preempted by an earlier slot's growth
            sched.ensure_page(slot, ahead=len(props.get(slot, ())) + 1)
        live = [(s, r) for s, r in live if sched.slots[s] is r]
        if not live:
            return 0
        Kv = ceil_pow2(max(len(props.get(s, ())) + 1 for s, _ in live))
        tokens = np.zeros((self.max_batch, Kv), np.int32)
        n_rows = np.zeros((self.max_batch,), np.int32)
        greedy = np.ones((self.max_batch,), np.int32)
        temp = np.ones((self.max_batch,), np.float32)
        topp = np.ones((self.max_batch,), np.float32)
        topk = np.zeros((self.max_batch,), np.int32)
        seeds = np.zeros((self.max_batch,), np.int32)
        fold = np.zeros((self.max_batch,), np.int32)
        for slot, r in live:
            drafts = props.get(slot, [])
            n_rows[slot] = 1 + len(drafts)
            tokens[slot, 0] = r.out[-1]
            tokens[slot, 1:1 + len(drafts)] = drafts
            greedy[slot] = 0 if r.do_sample else 1
            temp[slot] = r.temperature
            topp[slot] = r.top_p
            topk[slot] = r.top_k
            seeds[slot] = self._next_seed(r)
            fold[slot] = 1 if r.seed is None else 0
        self._step_phase = ("verify", tuple(s for s, _ in live))
        _faults.maybe_fire("serving.step", rids=[r.rid for _, r in live],
                           phase="verify")
        # the dispatch that captures the program (on the CPU: its first)
        compile_call = not self.runner.has_verify_program(Kv)
        self.spec_dispatches += 1
        self._m.verify.inc()
        t0 = time.perf_counter()
        with _obs.trace_span("serving.verify"):
            toks = self.runner.run_verify(
                Kv, tokens, sched.lens, sched.slot_tables, n_rows,
                greedy, temp, topp, topk, seeds, fold)       # [B, Kv]
        dt = time.perf_counter() - t0
        if self._spec.adaptive and not compile_call:
            self._record_verify_sample(Kv, dt)
        proposed = accepted = 0
        for slot, r in live:
            drafts = props.get(slot, [])
            n = len(drafts)
            t = toks[slot]
            # accept the longest draft prefix the target would have sampled
            # itself: draft j+1 (fed at row j+1) survives iff it equals the
            # token sampled from row j's logits
            a = 0
            while a < n and drafts[a] == int(t[a]):
                a += 1
            proposed += n
            accepted += a
            m = a + 1                                    # tokens to emit
            for j in range(m):
                if sched.slots[slot] is not r:
                    break        # eos / max_new released the slot mid-run
                sched.lens[slot] += 1
                sched.emit(slot, int(t[j]))
                self.spec_emitted += 1
            if sched.slots[slot] is r:
                # roll back KV pages provisioned for rejected drafts
                sched.truncate_pages(slot)
            if not compile_call and _obs.enabled():
                self._m.token_latency.observe(dt / m)
        self.spec_proposed += proposed
        self.spec_accepted += accepted
        self._m.spec_proposed.inc(proposed)
        self._m.spec_accepted.inc(accepted)
        if proposed:
            ratio = accepted / proposed
            self._m.spec_acceptance.observe(ratio)
            self._spec_accept_ema = (
                ratio if self._spec_accept_ema is None
                else 0.9 * self._spec_accept_ema + 0.1 * ratio)
        return len(live)

    def _record_verify_sample(self, rows, wall_dt):
        samples = self._spec_samples.setdefault(rows, [])
        samples.append(wall_dt)
        del samples[:-8]

    def _spec_draft_target(self):
        """Draft length maximizing expected emitted tokens per second,
        E(k) / t(rows(k)), from the verify step's OWN cost fit (decode
        blocks consume exactly k tokens; a verify step consumes a variable
        1..k+1, so it gets a separate t(rows) = RTT + rows*c model) and the
        acceptance-rate EMA: E(k) = 1 + a + a^2 + ... + a^k."""
        cfg = self._spec
        if not cfg.adaptive:
            return cfg.max_draft
        sampled = {kk: sorted(v)[len(v) // 2]
                   for kk, v in self._spec_samples.items() if v}
        if len(sampled) < 2:
            return cfg.max_draft      # not solvable yet: be optimistic
        ks = sorted(sampled)
        c, rtt = np.polyfit(np.asarray(ks, np.float64),
                            np.asarray([sampled[kk] for kk in ks],
                                       np.float64), 1)
        if c <= 0 or rtt < 0:
            return cfg.max_draft
        alpha = min(0.99, max(0.0, self._spec_accept_ema
                              if self._spec_accept_ema is not None else 0.5))
        best_k, best_rate = 1, -1.0
        for k in range(1, cfg.max_draft + 1):
            e = (k + 1 if alpha == 1.0
                 else (1 - alpha ** (k + 1)) / (1 - alpha))
            rate = e / (rtt + ceil_pow2(k + 1) * c)
            if rate > best_rate:
                best_rate, best_k = rate, k
        return best_k

    def spec_stats(self):
        """Always-on speculative-decoding counters (zero when the
        ``spec_decode`` knob is off). ``tokens_per_step`` is tokens emitted
        per VERIFY dispatch — the speculative speedup factor (> 1.0 means
        drafts are being accepted); the registry mirrors proposed/accepted
        as ``serving_spec_*_total`` plus the acceptance histogram."""
        return {
            "proposed": self.spec_proposed,
            "accepted": self.spec_accepted,
            "emitted": self.spec_emitted,
            "verify_dispatches": self.spec_dispatches,
            "acceptance_rate": (self.spec_accepted / self.spec_proposed
                                if self.spec_proposed else 0.0),
            "tokens_per_step": (self.spec_emitted / self.spec_dispatches
                                if self.spec_dispatches else 0.0),
            "draft_target": (self._spec_draft_target()
                             if self._spec is not None else 0),
        }
