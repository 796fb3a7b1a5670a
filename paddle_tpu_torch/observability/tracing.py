"""Span-scoped tracing bridging the metrics registry and the profiler.

One ``trace_span(name)`` emits, while observability is enabled:

1. a ``torch.profiler.record_function`` range — the span shows up in the
   ``torch.profiler`` timeline (and its chrome-trace export) whenever a
   profile is recording, and
2. an observation in the ``span_seconds`` histogram (label ``span=<name>``).

Disabled, a span costs one flag check and a no-op context manager.
"""
from __future__ import annotations

import time
from contextlib import contextmanager

from . import registry as _registry

SPAN_SECONDS = _registry.REGISTRY.histogram(
    "span_seconds", "wall time inside trace_span scopes", ("span",))


@contextmanager
def trace_span(name: str):
    """Time a scope into the registry and the profiler trace."""
    if not _registry._ENABLED:
        yield
        return
    import torch
    ann = torch.profiler.record_function(name)
    ann.__enter__()
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        ann.__exit__(None, None, None)
        SPAN_SECONDS.labels(span=name).observe(dt)
