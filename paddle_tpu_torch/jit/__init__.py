"""Captured programs (the counterpart of ``paddle_tpu.jit``): a step
recorded once into a CUDA graph and replayed, see :mod:`.capture`."""
from .capture import CapturedProgram, graph_pool  # noqa: F401

__all__ = ["CapturedProgram", "graph_pool"]
