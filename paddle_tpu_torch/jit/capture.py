"""Programs replayed from CUDA graphs: the port's counterpart of a jitted
program.

The JAX package compiles one XLA program per shape (``jax.jit`` in the
serving runner, ``paddle_tpu/jit/to_static.py`` for ``generate``'s decode
step), and each dispatch is one launch from the host.  PyTorch runs
eagerly: the same step issues every op of every layer from Python.  A
:class:`CapturedProgram` records such a step once into a
``torch.cuda.CUDAGraph`` and replays it, so a dispatch costs the host one
launch again.

A program owns static input buffers, a body that reads only those buffers
(and state that stays where it is, such as weights and caches written in
place), and the static outputs the body returned while it was captured.
:meth:`CapturedProgram.run` copies the caller's inputs into the buffers,
then

- on a CUDA device: the first call runs the body once on a side stream (the
  call's result; it also does every first-use host step: a kernel's build,
  its plan, the cuBLAS workspace) and captures it into a graph, in the
  memory pool its owner passed (shared by the owner's programs); every
  later call replays the graph;
- on the CPU: it calls the same body on the same buffers, so the tests run
  exactly the code that the card captures.

Outputs are copied out before ``run`` returns (a device clone, or the host
copy the caller asked for): a later replay never overwrites a tensor a
caller holds.  A capture that fails raises; nothing retries it eagerly.
:meth:`CapturedProgram.launch` runs the program on its buffers as they
stand and hands back its outputs uncopied, for an owner that stages its
inputs and reads its outputs itself (``jit.to_static``).

A body may also read and write external state in place (parameters,
optimizer moments, gradients) beside its staged inputs.  Running such a
body twice would apply its writes twice, so a program made with
``warm=False`` does not run its body before the capture: the first call
captures, then replays the graph once for its result (its owner warms
what the capture needs beforehand, as the spy call of ``to_static``
does).  ``generators`` are registered with the graph, so that each
replay draws fresh numbers from them instead of replaying the capture's.
:meth:`CapturedProgram.run_eager` runs the body (or a variant of it, on
the same buffers) uncaptured, for a dispatch the graph cannot serve, and
counts it.

Launch counters: each kernel wrapper counts the launches it makes in
Python, so a replay, which runs no Python, would count none.  The capture
records the launches its own thread counted into a tally of its own
(``ops._counts.recording``: a capture launches nothing, and launches that
other threads make meanwhile stay theirs), and each replay adds that
tally: the counters keep counting launches on the card.

Several engines may share a process and a card (a replica set, a fleet's
workers in threads), each capturing from its own thread.  Captures of one
device take turns under one lock, on the device's one capture stream, and
capture in ``thread_local`` error mode: what other threads do meanwhile (a
replay, a host copy, an allocation) is theirs, and neither invalidates
the capture nor is recorded into it.
"""
from __future__ import annotations

import gc
import threading
import time

import torch

from ..ops import _counts, flash_attention, paged_attention, quant_matmul

__all__ = ["CapturedProgram", "launch_counts", "graph_pool"]

_COUNTERS = (paged_attention.LAUNCH_COUNTERS + quant_matmul.LAUNCH_COUNTERS
             + flash_attention.LAUNCH_COUNTERS)


def launch_counts():
    """Every kernel launch counter of the port, ``{"fn.attr": count}``."""
    return {_counts.key(fn, attr): getattr(fn, attr)
            for fn, attr in _COUNTERS}


# One side stream a device for every warm-up and capture: PyTorch keeps a
# cuBLAS workspace for each stream that has run a GEMM, for the life of the
# process, so a fresh stream a capture would leave one behind each time
# (32 MiB each on the H100).  Warming up on the capture stream also
# allocates that workspace before the capture begins.
_STREAMS: dict = {}
# One lock a device: its captures take turns on its one capture stream
# (reentrant: a body's warm-up run may capture a program of its own).
_LOCKS: dict = {}
_LOCKS_GUARD = threading.Lock()


def _capture_stream(device):
    if device not in _STREAMS:
        _STREAMS[device] = torch.cuda.Stream(device)
    return _STREAMS[device]


def _capture_lock(device):
    with _LOCKS_GUARD:
        return _LOCKS.setdefault(device, threading.RLock())


def graph_pool(device):
    """A memory pool for the graphs of one owner on ``device`` (None on the
    CPU, where nothing is captured)."""
    return (torch.cuda.graph_pool_handle()
            if torch.device(device).type == "cuda" else None)


class CapturedProgram:
    """One program: ``body(buffers)`` returns a tensor or a tuple of
    tensors computed from ``buffers`` (name -> static input tensor, all on
    one device).  ``pool``: the graph memory pool (:func:`graph_pool`)."""

    def __init__(self, body, buffers, pool=None, name="program", warm=True,
                 device=None, generators=()):
        self.body = body
        self.buffers = buffers
        self.pool = pool
        self.name = name
        self.warm = warm
        self.generators = tuple(generators)
        self.device = torch.device(device) if device is not None else \
            next(iter(buffers.values())).device
        self.graph = None
        self.outputs = None          # the graph's static outputs
        self.launches = {}           # counter -> launches a replay makes
        self.runs = 0                # calls of run()
        self.captures = 0
        self.replays = 0
        self.eager = 0               # calls of run_eager()
        self.capture_s = 0.0
        self.capture_wait_s = 0.0    # waiting for another capture's turn

    @property
    def ready(self):
        """On the card: a graph exists.  On the CPU: the body has run once
        through :meth:`run` (the first call, which the card captures)."""
        if self.device.type == "cuda":
            return self.graph is not None
        return self.runs > 0

    def stats(self):
        return {"runs": self.runs, "captures": self.captures,
                "replays": self.replays, "eager": self.eager,
                "capture_s": self.capture_s,
                "capture_wait_s": self.capture_wait_s,
                "launches_a_replay": dict(self.launches)}

    def _stage(self, inputs):
        """Copy each input (array, number or tensor) into its buffer; the
        shape must match, the dtype is converted."""
        for name, value in inputs.items():
            buf = self.buffers[name]
            src = torch.as_tensor(value)
            if tuple(src.shape) != tuple(buf.shape):
                raise ValueError(
                    f"{self.name}: input {name!r} has shape "
                    f"{tuple(src.shape)}, its buffer {tuple(buf.shape)}")
            buf.copy_(src)

    @staticmethod
    def _copy_out(out, host, take):
        if take is not None:
            out = out[take]
        one = isinstance(out, torch.Tensor)
        outs = (out,) if one else tuple(out)
        outs = tuple(t.cpu() if host else t.clone() for t in outs)
        return outs[0] if one else outs

    def launch(self):
        """Run the program on its buffers as they stand; returns its
        outputs as the body made them (on the card the graph's static
        outputs, which the next replay overwrites)."""
        self.runs += 1
        if self.device.type != "cuda":
            return self.body(self.buffers)
        if self.graph is None:
            return self._capture()
        self.graph.replay()
        _counts.add(_COUNTERS, self.launches)
        self.replays += 1
        return self.outputs

    def run(self, inputs, host=False, take=None):
        """Stage ``inputs`` ({name: value}) and run the program; returns
        copies of its outputs (on the host with ``host``; with ``take``,
        of output ``take`` alone)."""
        self._stage(inputs)
        return self._copy_out(self.launch(), host, take)

    def run_eager(self, inputs, body=None, host=False, take=None):
        """Stage ``inputs`` and run ``body`` (default: the program's own)
        on the buffers uncaptured; counted in ``eager``."""
        self._stage(inputs)
        self.eager += 1
        return self._copy_out((body or self.body)(self.buffers), host, take)

    def _capture(self):
        """Run the body on the side stream (this call's result; not with
        ``warm=False``), then capture it there, in the device's turn.  The
        capture's kernels do not run: the launches its thread (or its
        stream) counted are kept as those of one replay, off the counters.
        With ``warm=False`` the call's result is one replay of the new
        graph."""
        t0 = time.perf_counter()
        with _capture_lock(self.device):
            t_turn = time.perf_counter()
            main = torch.cuda.current_stream(self.device)
            side = _capture_stream(self.device)
            if self.warm:
                side.wait_stream(main)
                with torch.cuda.stream(side):
                    out = self.body(self.buffers)
                main.wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            for gen in self.generators:
                register = getattr(graph, "register_generator_state", None)
                if register is None:
                    raise RuntimeError(
                        f"{self.name}: this torch cannot register a "
                        "generator with a CUDA graph, so its replays would "
                        "repeat the capture's random draws")
                register(gen)
            # no cyclic collection while capturing (torch.cuda.graph
            # collects once before it begins): a collection inside the
            # body could free a dead engine's graph, whose destruction is
            # not permitted while a stream captures, and the capture fails
            collect = gc.isenabled()
            gc.disable()
            try:
                with _counts.recording(side) as tally:
                    with torch.cuda.graph(graph, pool=self.pool, stream=side,
                                          capture_error_mode="thread_local"):
                        outputs = self.body(self.buffers)
            finally:
                if collect:
                    gc.enable()
            self.launches = {k: n for k, n in tally.items() if n}
            self.graph, self.outputs = graph, outputs
            if not self.warm:
                graph.replay()
                _counts.add(_COUNTERS, self.launches)
                out = outputs
            torch.cuda.synchronize(self.device)
        self.captures += 1
        self.capture_wait_s += t_turn - t0
        self.capture_s += time.perf_counter() - t_turn
        return out
