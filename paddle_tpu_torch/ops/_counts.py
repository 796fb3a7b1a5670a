"""Kernel launch counters that stay exact when several threads launch.

Each wrapper counts its launches in a plain int attribute of its function
(``paged_attention.launches``), read and reset by callers.  Serving runs
engines in threads of their own (one step thread a replica, a worker's RPC
threads), so a counter is bumped through :func:`count`: under a lock, so
no increment is lost, or, while the calling thread captures a CUDA graph
(:func:`recording`), into that capture's own tally, so a capture never
takes in the launches another thread makes meanwhile.  A captured train
step's backward runs on autograd's device thread, not the capturing one:
a tally recorded for a capture stream also takes the launches that any
thread counts while that stream is its current one.
"""
from __future__ import annotations

import contextlib
import threading

__all__ = ["count", "add", "recording", "key"]

_lock = threading.Lock()
_local = threading.local()
_stream_tallies: dict = {}      # capture stream handle -> its capture's tally


def key(fn, attr):
    """The name of counter ``fn.attr``: ``"fn.attr"``."""
    return f"{fn.__name__}.{attr}"


def _stream_tally():
    """The tally of the capture whose stream is this thread's current one."""
    import torch
    return _stream_tallies.get(torch.cuda.current_stream().cuda_stream)


def count(fn, attr, n=1):
    """Add ``n`` launches to ``fn.attr``, or to the capture tally of the
    calling thread or of its current stream while one is recorded."""
    tally = getattr(_local, "tally", None)
    if tally is None and _stream_tallies:
        tally = _stream_tally()
    with _lock:
        if tally is not None:
            k = key(fn, attr)
            tally[k] = tally.get(k, 0) + n
            return
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
def recording(stream=None):
    """Inside the block, the launches this thread counts go to the yielded
    dict ({"fn.attr": n}) instead of the counters, and with ``stream`` (a
    capture stream) so do those any thread counts on that stream; other
    threads count as before."""
    prev = getattr(_local, "tally", None)
    tally = {}
    _local.tally = tally
    handle = None if stream is None else stream.cuda_stream
    if handle is not None:
        with _lock:
            _stream_tallies[handle] = tally
    try:
        yield tally
    finally:
        _local.tally = prev
        if handle is not None:
            with _lock:
                _stream_tallies.pop(handle, None)
