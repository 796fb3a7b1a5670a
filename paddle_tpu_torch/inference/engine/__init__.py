"""Engine core as a package, split along its natural interfaces (the
counterpart of ``paddle_tpu.inference.engine``).

Layering (each module imports only what is below it):

    request    Request / RequestStatus / prefix_page_keys — lifecycle types
    metrics    _EngineMetrics — per-engine registry children (labelled)
    compat     _LegacyDelegation — the pre-split private-attribute surface
    pages      PagePool — paged-KV accounting: refcounts, prefix-cache
               chain-hash index, LRU reclaim, audit
    runner     ModelRunner — the prefill/decode/verify forwards and the KV
               buffers (bf16/f32 or int8 pages) on ONE device, plus page
               gather/scatter for the KV tiers
    spec       SpecConfig, the draft proposers, and the engine's
               speculative-decode orchestration mixin
    scheduler  Scheduler — admission, deadlines, continuous batching,
               preemption, slot/page-table state
    core       LLMEngine — the facade composing the above; owns step
               policy, failure isolation, and the auto-fits
    disagg     DisaggEngine — prefill and decode LLMEngines, each on one
               device, with KV-page handoff between their pools

``paddle_tpu_torch.inference.serving`` re-exports the public names.
"""
from .request import Request, RequestStatus, prefix_page_keys
from .pages import PagePool
from .runner import ModelRunner
from .spec import SpecConfig
from .scheduler import Scheduler
from .core import LLMEngine
from .disagg import DisaggEngine

__all__ = [
    "LLMEngine", "DisaggEngine", "Scheduler", "PagePool", "ModelRunner",
    "Request", "RequestStatus", "SpecConfig", "prefix_page_keys",
]
