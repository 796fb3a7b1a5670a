"""Request lifecycle types shared by every engine-core module.

This is the bottom of the engine package's layering: ``request`` imports
nothing from its siblings (``pages``, ``scheduler``, ``runner``, ``core``,
``disagg``) — the import-cycle guard in ``tests/test_analysis.py`` keeps it
that way.
"""
from __future__ import annotations

import enum
import time

import numpy as np

__all__ = ["Request", "RequestStatus", "prefix_page_keys"]


def prefix_page_keys(tokens, page_size):
    """Chain key per FULL page: key_i = hash(key_{i-1}, page_i tokens).

    The prefix-cache radix lookup collapsed to one dict probe per page — a
    page is shareable only as the tail of an identical-from-position-0
    prefix (RoPE bakes absolute positions into cached K, so content alone
    is not enough).  Public because the serving front door computes the
    SAME keys to route a request to the replica whose cache already holds
    its prefix (frontend/router.py); the engine's own radix index uses
    this function too, so router affinity and engine hits can never
    disagree on hashing."""
    page_size = int(page_size)
    keys, h = [], None
    for i in range(0, (len(tokens) // page_size) * page_size, page_size):
        h = hash((h,) + tuple(int(t) for t in tokens[i:i + page_size]))
        keys.append(h)
    return keys


class RequestStatus(enum.Enum):
    """Request lifecycle. Exactly one terminal status per request:

    FINISHED   max_new_tokens (or engine max_len) reached
    EOS        the eos token was sampled
    TIMEOUT    deadline expired (waiting: shed unserved; mid-decode: the
               partial output is kept and the slot finalized cleanly)
    CANCELLED  ``cancel(rid)`` — pages released through the refcounts
    SHED       admission control refused the request at add_request
    FAILED     quarantined by step-failure isolation (``Request.error`` holds
               the underlying exception text)
    """
    QUEUED = "queued"
    RUNNING = "running"
    FINISHED = "finished"
    EOS = "eos"
    TIMEOUT = "timeout"
    CANCELLED = "cancelled"
    SHED = "shed"
    FAILED = "failed"

    @property
    def terminal(self):
        return self not in (RequestStatus.QUEUED, RequestStatus.RUNNING)


TERMINAL_STATUSES = tuple(s for s in RequestStatus if s.terminal)


class Request:
    def __init__(self, rid, prompt_ids, max_new_tokens, eos_token_id=None,
                 do_sample=False, temperature=1.0, top_p=1.0, top_k=0,
                 seed=None, deadline=None, resume_tokens=None):
        """``resume_tokens``: output history from a previous incarnation of
        this request (a replica that died mid-stream).  The history folds
        into the prompt exactly like preemption folds ``prompt0 + out`` —
        it re-prefills as context, the first token sampled here continues
        the sequence, and ``out`` holds only NEW tokens so the streaming
        accessors never re-emit what the caller already has."""
        self.rid = rid
        self.prompt = list(int(t) for t in np.asarray(prompt_ids).reshape(-1))
        self.resumed_from = 0
        if resume_tokens is not None:
            resume = [int(t) for t in resume_tokens]
            self.prompt += resume
            self.resumed_from = len(resume)
        self.prompt0 = list(self.prompt)   # original; preemption re-folds
        self.max_new = int(max_new_tokens)
        self.eos = eos_token_id
        self.do_sample = bool(do_sample)
        self.temperature = float(temperature)
        self.top_p = float(top_p)
        self.top_k = int(top_k)
        self.seed = seed
        self.out: list[int] = []
        self.pos = 0                 # prompt tokens already prefilled
        self.slot = None
        self.done = False
        self.admit_seq = -1          # preemption picks the youngest
        self.t_submit = time.perf_counter()
        # absolute wall deadline; expiry sheds a waiting request and cleanly
        # finalizes a decoding one (both terminal status TIMEOUT)
        self.deadline = (None if deadline is None
                         else self.t_submit + float(deadline))
        self.status = RequestStatus.QUEUED
        self.error = None            # exception text when status is FAILED
        self.t_finish = None
        self.ttft = None             # seconds to first generated token
        self.prefill_dispatches = 0  # prefill programs dispatched for us
        self.cached_tokens = 0       # prompt tokens served from prefix cache
        self.cache_keys = ()         # chain keys of the prompt's full pages
        self.stream_pos = 0          # tokens already handed to new_tokens()
        self.trace_id = None         # flight-recorder trace (ambient ctx)
