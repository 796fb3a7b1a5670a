"""Kernel launch counters that stay exact when several threads launch.

Each wrapper counts its launches in a plain int attribute of its function
(``paged_attention.launches``), read and reset by callers.  Serving runs
engines in threads of their own (one step thread a replica, a worker's RPC
threads), so a counter is bumped through :func:`count`: under a lock, so
no increment is lost, or, while the calling thread captures a CUDA graph
(:func:`recording`), into that capture's own tally, so a capture never
takes in the launches another thread makes meanwhile.
"""
from __future__ import annotations

import contextlib
import threading

__all__ = ["count", "add", "recording", "key"]

_lock = threading.Lock()
_local = threading.local()


def key(fn, attr):
    """The name of counter ``fn.attr``: ``"fn.attr"``."""
    return f"{fn.__name__}.{attr}"


def count(fn, attr, n=1):
    """Add ``n`` launches to ``fn.attr``, or to the calling thread's
    capture tally while it records one."""
    tally = getattr(_local, "tally", None)
    if tally is not None:
        k = key(fn, attr)
        tally[k] = tally.get(k, 0) + n
        return
    with _lock:
        setattr(fn, attr, getattr(fn, attr) + n)


def add(counters, deltas):
    """Add ``deltas`` ({"fn.attr": n}) to the counters of ``counters``
    ((fn, attr) pairs) at once: what one graph replay launched."""
    with _lock:
        for fn, attr in counters:
            d = deltas.get(key(fn, attr))
            if d:
                setattr(fn, attr, getattr(fn, attr) + d)


@contextlib.contextmanager
def recording():
    """Inside the block, the launches this thread counts go to the yielded
    dict ({"fn.attr": n}) instead of the counters; other threads count as
    before."""
    prev = getattr(_local, "tally", None)
    tally = {}
    _local.tally = tally
    try:
        yield tally
    finally:
        _local.tally = prev
