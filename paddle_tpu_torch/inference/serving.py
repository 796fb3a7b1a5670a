"""Serving runtime: the stable import surface of the engine package (the
counterpart of ``paddle_tpu.inference.serving``).

The implementation lives in :mod:`paddle_tpu_torch.inference.engine`:
a chunked PREFILL step and a token-level continuous-batching DECODE step
over a paged KV cache [L, n_pages, page, KVH, D] (int8 pages with float32
scales under ``kv_cache_dtype="int8"``), with host-managed per-slot page
tables, on-demand growth, youngest-slot preemption-recompute, automatic
prefix caching, and speculative decoding (``spec_decode=SpecConfig()``: an
n-gram or draft-model proposer, one multi-query VERIFY step, paged-KV
rollback).  ``DisaggEngine`` serves through prefill and decode engines with
KV-page handoff between them.  On the card, attention runs the
hand-written paged-attention CUDA kernels.
"""
from __future__ import annotations

from .engine import (  # noqa: F401
    DisaggEngine,
    LLMEngine,
    ModelRunner,
    PagePool,
    Request,
    RequestStatus,
    Scheduler,
    SpecConfig,
    prefix_page_keys,
)
from .engine.spec import _NgramProposer  # noqa: F401  (test import)

__all__ = ["LLMEngine", "DisaggEngine", "Request", "RequestStatus",
           "SpecConfig", "prefix_page_keys", "Scheduler", "PagePool",
           "ModelRunner"]
