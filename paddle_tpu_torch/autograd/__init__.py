"""Autograd public API: counterpart of ``paddle_tpu/autograd/__init__.py``
(reference: python/paddle/autograd/__init__.py).

The grad mode is torch's: ``no_grad`` / ``enable_grad`` /
``set_grad_enabled`` switch ``torch.is_grad_enabled()``, so they and
torch's own context managers are one switch.
"""
from __future__ import annotations

import functools

import torch

from ..core.dispatch import set_grad_enabled as _set, grad_enabled
from ..core.tensor import Tensor, _wrap
from .backward import backward, grad  # noqa: F401
from .functional import jacobian, hessian  # noqa: F401


class no_grad:
    """Context manager & decorator disabling tape recording (paddle.no_grad)."""

    def __enter__(self):
        self._prev = _set(False)
        return self

    def __exit__(self, *exc):
        _set(self._prev)
        return False

    def __call__(self, fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            with no_grad():
                return fn(*args, **kwargs)
        return wrapper


class enable_grad:
    def __enter__(self):
        self._prev = _set(True)
        return self

    def __exit__(self, *exc):
        _set(self._prev)
        return False

    def __call__(self, fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            with enable_grad():
                return fn(*args, **kwargs)
        return wrapper


class set_grad_enabled:
    def __init__(self, mode: bool):
        self._mode = mode
        self._prev = _set(mode)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        _set(self._prev)
        return False


def is_grad_enabled() -> bool:
    return grad_enabled()


# ---- PyLayer -----------------------------------------------------------------
class PyLayerContext:
    """ctx passed to PyLayer.forward/backward (python/paddle/autograd/py_layer.py:36)."""

    def __init__(self):
        self._saved = ()
        self.not_inplace_tensors = ()

    def save_for_backward(self, *tensors):
        self._saved = tuple(tensors)

    @property
    def saved_tensor(self):
        return self._saved

    def saved_tensors(self):
        return self._saved


class _PyLayerFunction(torch.autograd.Function):
    """One PyLayer call on torch's tape: forward runs the user's forward on
    the original Tensors (torch has grad recording off there), backward
    wraps the output cotangents, runs the user's backward and unwraps one
    gradient per Tensor input."""

    @staticmethod
    def forward(tctx, cls, ctx, call, *bufs):
        args, kwargs = call
        outs = cls.forward(ctx, *args, **kwargs)
        tctx.cls, tctx.ctx, tctx.n_in = cls, ctx, len(bufs)
        outs_t = tuple(outs) if isinstance(outs, (tuple, list)) else (outs,)
        return tuple(o._buf if isinstance(o, Tensor) else o for o in outs_t)

    @staticmethod
    def backward(tctx, *cots):
        gin = tctx.cls.backward(tctx.ctx, *[_wrap(c) for c in cots])
        gin_t = (gin,) if not isinstance(gin, (tuple, list)) else tuple(gin)
        grads = [g._buf if isinstance(g, Tensor) else g for g in gin_t]
        grads += [None] * (tctx.n_in - len(grads))
        return (None, None, None) + tuple(grads)


class PyLayerMeta(type):
    def __init__(cls, name, bases, ns):
        super().__init__(name, bases, ns)


class PyLayer(metaclass=PyLayerMeta):
    """User-defined differentiable function with explicit forward/backward,
    as a ``torch.autograd.Function``: forward sees the caller's Tensors with
    grad recording off; backward gets the outputs' gradients as Tensors and
    returns one gradient (or None) per Tensor input."""

    @staticmethod
    def forward(ctx, *args, **kwargs):
        raise NotImplementedError

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError

    @classmethod
    def apply(cls, *args, **kwargs):
        ctx = PyLayerContext()
        bufs = [a._buf for a in args if isinstance(a, Tensor)]
        outs = _PyLayerFunction.apply(cls, ctx, (args, kwargs), *bufs)
        wrapped = tuple(_wrap(o) for o in outs)
        return wrapped[0] if len(wrapped) == 1 else wrapped

