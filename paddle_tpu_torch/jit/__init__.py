"""paddle.jit (the counterpart of ``paddle_tpu.jit``; reference:
python/paddle/jit/api.py — to_static:197, save:956, load:1527).

``to_static`` / ``scan_steps`` capture a step as a CUDA graph on the card
(:mod:`.to_static`), built on :mod:`.capture`'s ``CapturedProgram``, which
also serves the runner's programs.  ``save`` / ``load`` export StableHLO
through ``jax.export`` in the reference; the port has no export format
yet (queue 1, M13's ``jit.save`` / ``jit.load``), and they raise.
"""
from __future__ import annotations

import logging

from .capture import CapturedProgram, graph_pool  # noqa: F401
from .to_static import (to_static, not_to_static, StaticFunction,  # noqa: F401
                        scan_steps, ScanStaticFunction)

__all__ = ["CapturedProgram", "graph_pool", "to_static", "not_to_static",
           "StaticFunction", "scan_steps", "ScanStaticFunction", "InputSpec",
           "enable_to_static", "ignore_module", "set_verbosity",
           "set_code_level", "save", "load"]

ignore_module = lambda *a, **k: None  # noqa: E731 — SOT-only concept


def enable_to_static(flag=True):
    pass


class InputSpec:
    """reference: python/paddle/static/input.py InputSpec."""

    def __init__(self, shape=None, dtype="float32", name=None, stop_gradient=True):
        from ..core.dtype import convert_dtype
        self.shape = list(shape) if shape is not None else None
        self.dtype = convert_dtype(dtype)
        self.name = name
        self.stop_gradient = stop_gradient

    @classmethod
    def from_tensor(cls, tensor, name=None):
        return cls(tensor.shape, tensor.dtype, name or tensor.name)

    def __repr__(self):
        return f"InputSpec(shape={self.shape}, dtype={self.dtype}, name={self.name})"


def save(layer, path, input_spec=None, **configs):
    """paddle.jit.save: not ported (the reference exports StableHLO)."""
    raise NotImplementedError(
        "jit.save exports a program; the port has no export format yet "
        "(jit.save / jit.load, ROADMAP queue 1, M13)")


def load(path, **configs):
    """paddle.jit.load: not ported (see :func:`save`)."""
    raise NotImplementedError(
        "jit.load reads an exported program; the port has no export format "
        "yet (jit.save / jit.load, ROADMAP queue 1, M13)")


_verbosity = 0
_code_level = 0


def set_verbosity(level=0, also_to_stdout=False):
    """reference jit/dy2static/logging_utils.py set_verbosity: controls how
    chatty the capture pipeline is."""
    global _verbosity
    _verbosity = int(level)
    logging.getLogger("paddle_tpu_torch.jit").setLevel(
        logging.DEBUG if level else logging.WARNING)


def set_code_level(level=100, also_to_stdout=False):
    """reference jit set_code_level: at >0, to_static prints the captured
    program (the op sequence of the step) when it captures it."""
    global _code_level
    _code_level = int(level)


def _code_level_value():
    return _code_level
