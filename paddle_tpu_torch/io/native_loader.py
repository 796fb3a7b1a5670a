"""Native (C++) batch-gather fast path for DataLoader.

Reference analog: the C++ data plane (fluid/framework/data_feed.cc, the
DataLoader's C++ worker pool) — the reference feeds training from native
threads, not Python. Here `NativeArrayLoader` drives the pthread gather engine
in core/native/dataloader.cc over contiguous host arrays: workers assemble
batch buffers ahead of consumption (bounded by `depth`). Each delivered batch
is one native gather into the engine slot plus one memcpy out (the consumer
owns its batches across steps, so the slot can be recycled immediately); the
Python-side fancy-indexing and per-sample collate of the mp path are gone.

Used automatically by DataLoader for TensorDataset/array datasets with
num_workers > 0 and the default collate (engine="auto"), with the Python
multiprocessing path as fallback when the toolchain is unavailable.
"""
from __future__ import annotations

import ctypes
import threading

import numpy as np

_lib = None
_lib_tried = False


def _load():
    global _lib, _lib_tried
    if _lib_tried:
        return _lib
    _lib_tried = True
    from ..core.native.build import load
    lib = load("pt_dataloader", "dataloader.cc")
    if lib is None:
        return None
    lib.pt_dl_create.restype = ctypes.c_void_p
    lib.pt_dl_create.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                 ctypes.c_int64, ctypes.c_int, ctypes.c_int]
    lib.pt_dl_submit.restype = ctypes.c_int
    lib.pt_dl_submit.argtypes = [ctypes.c_void_p,
                                 ctypes.POINTER(ctypes.c_int64),
                                 ctypes.c_int64]
    lib.pt_dl_acquire.restype = ctypes.c_int64
    lib.pt_dl_acquire.argtypes = [ctypes.c_void_p,
                                  ctypes.POINTER(ctypes.c_void_p)]
    lib.pt_dl_release.argtypes = [ctypes.c_void_p]
    lib.pt_dl_close.argtypes = [ctypes.c_void_p]
    lib.pt_dl_destroy.argtypes = [ctypes.c_void_p]
    _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


class _Engine:
    """One gather engine over one contiguous array ([N, ...] row-major)."""

    def __init__(self, array: np.ndarray, n_threads: int, depth: int):
        lib = _load()
        if lib is None:
            raise RuntimeError("native dataloader unavailable")
        self._lib = lib
        self._arr = np.ascontiguousarray(array)   # keep alive: C++ reads it
        self._row_shape = self._arr.shape[1:]
        self._row_bytes = int(self._arr.dtype.itemsize *
                              int(np.prod(self._row_shape, dtype=np.int64)))
        self._h = lib.pt_dl_create(
            self._arr.ctypes.data_as(ctypes.c_void_p),
            self._arr.shape[0], self._row_bytes, n_threads, depth)
        if not self._h:
            raise RuntimeError("pt_dl_create failed")

    def submit(self, indices: np.ndarray) -> None:
        idx = np.ascontiguousarray(indices, dtype=np.int64)
        rc = self._lib.pt_dl_submit(
            self._h, idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            len(idx))
        if rc != 0:
            raise RuntimeError("pt_dl_submit failed (closed or bad index)")

    def acquire(self):
        """-> np view [n, *row_shape] valid until the next acquire, or None."""
        ptr = ctypes.c_void_p()
        n = self._lib.pt_dl_acquire(self._h, ctypes.byref(ptr))
        if n < 0:
            return None
        nbytes = int(n) * self._row_bytes
        raw = (ctypes.c_uint8 * nbytes).from_address(ptr.value)
        view = np.frombuffer(raw, dtype=self._arr.dtype)
        return view.reshape((int(n),) + self._row_shape)

    def close(self):
        self._lib.pt_dl_close(self._h)

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            self._lib.pt_dl_destroy(h)
            self._h = None


class NativeArrayLoader:
    """Iterate (batches of) one or more parallel arrays in native threads.

    arrays: list of [N, ...] numpy arrays sharing N (the TensorDataset
    layout). index_batches: iterable of per-batch row-index lists. Yields
    tuples of OWNED numpy arrays (copied out of the engine slot, so the
    consumer may hold them across steps)."""

    def __init__(self, arrays, index_batches, num_threads=4, depth=4):
        self._arrays = [np.asarray(a) for a in arrays]
        n = self._arrays[0].shape[0]
        for a in self._arrays:
            if a.shape[0] != n:
                raise ValueError("parallel arrays must share dim 0")
        self._batches = index_batches
        self._threads = max(1, num_threads)
        self._depth = max(1, depth)

    def __iter__(self):
        # the thread budget is TOTAL, split across the per-array engines with
        # the remainder distributed; each engine needs >= 1 thread, so more
        # arrays than budget means a mild oversubscription by design
        k = len(self._arrays)
        base, rem = divmod(self._threads, k)
        engines = [_Engine(a, max(1, base + (1 if i < rem else 0)),
                           self._depth)
                   for i, a in enumerate(self._arrays)]
        err = []

        def feed():
            try:
                for batch in self._batches:
                    for e in engines:
                        e.submit(np.asarray(batch))
            except Exception as ex:  # surfaced on the consumer side
                err.append(ex)
            finally:
                for e in engines:
                    e.close()

        feeder = threading.Thread(target=feed, daemon=True)
        feeder.start()
        try:
            while True:
                views = [e.acquire() for e in engines]
                if any(v is None for v in views):
                    break
                yield tuple(v.copy() for v in views)
            if err:
                raise err[0]
        finally:
            feeder.join(timeout=5)
            del engines
