"""Quantization bases (reference: python/paddle/quantization/base_observer.py,
base_quanter.py, factory.py): counterpart of
``paddle_tpu/quantization/base.py``.

Fake-quant is ONE op with a custom straight-through backward (a
``torch.autograd.Function`` where the reference has a ``jax.custom_vjp``)
dispatched like every other op, so a QAT step captures into one CUDA graph
under to_static; observers keep their running statistics in Layer buffers."""
from __future__ import annotations

import torch

from ..nn.layer.layers import Layer

__all__ = ["BaseObserver", "BaseQuanter", "ObserverFactory", "QuanterFactory",
           "quanter", "fake_quant"]


def fake_quant(x, scale, qmax):
    """Symmetric fake quantize-dequantize: round(x/s*qmax)/qmax*s, clipped.

    scale broadcasts against x (scalar for per-tensor, shaped for
    per-channel). The backward is the clipped straight-through estimator
    (reference: fake_quantize_dequantize_moving_average_abs_max grad).
    Takes torch tensors (numpy arrays and Python numbers are converted)."""
    x = torch.as_tensor(x)
    scale = torch.as_tensor(scale, device=x.device)
    if not scale.is_floating_point():
        scale = scale.float()
    return _FakeQuant.apply(x, scale, qmax)


class _FakeQuant(torch.autograd.Function):
    """The forward in the reference's order: s = max(scale, 1e-9) cast to
    x's dtype, then clip(round(x / s * qmax), -qmax, qmax) / qmax * s
    (``torch.round`` rounds half to even, as ``jnp.round``)."""

    @staticmethod
    def forward(ctx, x, scale, qmax):
        s = torch.clamp_min(scale, 1e-9).to(x.dtype)
        ctx.save_for_backward(x, s)
        ctx.scale_shape = scale.shape
        return torch.clamp(torch.round(x / s * qmax), -qmax, qmax) / qmax * s

    @staticmethod
    def backward(ctx, g):
        x, s = ctx.saved_tensors
        mask = (torch.abs(x) <= s).to(g.dtype)
        # no gradient to the observer-updated scale; qmax is not
        # differentiable
        return g * mask, torch.zeros(ctx.scale_shape, dtype=g.dtype,
                                     device=g.device), None


class BaseObserver(Layer):
    """Collects statistics on the tensors flowing through it; identity in
    the forward graph (reference: base_observer.py BaseObserver)."""

    def bit_length(self):
        return 8

    def quant_axis(self):
        return -1

    def scales(self):
        raise NotImplementedError

    def zero_points(self):
        return None

    def cal_thresholds(self):
        pass


class BaseQuanter(BaseObserver):
    """Applies fake quantization in forward (reference: base_quanter.py)."""


class _Factory:
    """Holds a quanter/observer class + kwargs; instantiated per wrapped
    layer (reference: factory.py ObserverFactory/QuanterFactory)."""

    def __init__(self, cls=None, **kwargs):
        self._cls = cls or self._get_class()
        self._kwargs = kwargs

    def _get_class(self):
        raise NotImplementedError

    def _instance(self, layer):
        return self._cls(layer, **self._kwargs)


class ObserverFactory(_Factory):
    pass


class QuanterFactory(_Factory):
    pass


def quanter(name):
    """Class decorator registering a quanter layer under a factory name
    (reference: factory.py quanter). Returns the class unchanged and
    exposes `<name>` as a factory in the class's module."""
    def deco(cls):
        import sys
        mod = sys.modules[cls.__module__]

        class _F(QuanterFactory):
            def _get_class(self):
                return cls
        _F.__name__ = name
        setattr(mod, name, _F)
        return cls
    return deco
