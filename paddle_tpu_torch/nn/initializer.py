"""Weight initializers: counterpart of ``paddle_tpu/nn/initializer.py``
(reference: python/paddle/nn/initializer/).

An initializer is called with a shape and a dtype and returns a torch
tensor on the current place (``core.device.current_device``).  Random
draws come from the global generator of ``core/rng.py`` (``paddle.seed``)
on that place, in float32, cast to the dtype: torch's Philox / Mersenne
Twister, so they do not match the reference's threefry draws for the same
seed.  The fan conventions, gains and limits are the reference's.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..core import dtype as dtypes
from ..core.device import current_device
from ..core.rng import next_generator
from ..core.tensor import Tensor


def _normal(shape):
    dev = current_device()
    return torch.randn(tuple(shape), generator=next_generator(dev),
                       dtype=torch.float32, device=dev)


def _uniform(shape, low, high):
    dev = current_device()
    u = torch.rand(tuple(shape), generator=next_generator(dev),
                   dtype=torch.float32, device=dev)
    return u * (high - low) + low


class Initializer:
    def __call__(self, shape, dtype):
        raise NotImplementedError


class Constant(Initializer):
    def __init__(self, value=0.0):
        self.value = value

    def __call__(self, shape, dtype):
        return torch.full(tuple(shape), self.value,
                          dtype=dtypes.convert_dtype(dtype),
                          device=current_device())


class Normal(Initializer):
    def __init__(self, mean=0.0, std=1.0):
        self.mean, self.std = mean, std

    def __call__(self, shape, dtype):
        out = _normal(shape)
        return (out * self.std + self.mean).to(dtypes.convert_dtype(dtype))


class TruncatedNormal(Initializer):
    """N(0, 1) truncated to [a, b] by the inverse CDF of a uniform draw
    between the bounds' CDFs, then scaled and shifted."""

    def __init__(self, mean=0.0, std=1.0, a=-2.0, b=2.0):
        self.mean, self.std, self.a, self.b = mean, std, a, b

    def __call__(self, shape, dtype):
        def cdf(v):
            return 0.5 * (1.0 + math.erf(v / math.sqrt(2.0)))
        u = _uniform(shape, cdf(self.a), cdf(self.b))
        out = torch.erfinv(2.0 * u - 1.0) * math.sqrt(2.0)
        out = out.clamp(self.a, self.b)
        return (out * self.std + self.mean).to(dtypes.convert_dtype(dtype))


class Uniform(Initializer):
    def __init__(self, low=-1.0, high=1.0):
        self.low, self.high = low, high

    def __call__(self, shape, dtype):
        out = _uniform(shape, self.low, self.high)
        return out.to(dtypes.convert_dtype(dtype))


def _fans(shape):
    shape = tuple(shape)
    if len(shape) < 1:
        return 1, 1
    if len(shape) == 1:
        return shape[0], shape[0]
    receptive = int(np.prod(shape[2:])) if len(shape) > 2 else 1
    # paddle convention: fan_in = shape[0]*rf for conv (NCHW weight OIHW),
    # for 2D [in, out] linear weights fan_in = shape[0]
    fan_in = shape[1] * receptive if len(shape) > 2 else shape[0]
    fan_out = shape[0] * receptive if len(shape) > 2 else shape[1]
    return fan_in, fan_out


class XavierNormal(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain=1.0):
        self._fan_in, self._fan_out, self.gain = fan_in, fan_out, gain

    def __call__(self, shape, dtype):
        fi, fo = _fans(shape)
        fi = self._fan_in if self._fan_in is not None else fi
        fo = self._fan_out if self._fan_out is not None else fo
        std = self.gain * math.sqrt(2.0 / (fi + fo))
        return (_normal(shape) * std).to(dtypes.convert_dtype(dtype))


class XavierUniform(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain=1.0):
        self._fan_in, self._fan_out, self.gain = fan_in, fan_out, gain

    def __call__(self, shape, dtype):
        fi, fo = _fans(shape)
        fi = self._fan_in if self._fan_in is not None else fi
        fo = self._fan_out if self._fan_out is not None else fo
        limit = self.gain * math.sqrt(6.0 / (fi + fo))
        return _uniform(shape, -limit, limit).to(dtypes.convert_dtype(dtype))


def _kaiming_gain(negative_slope, nonlinearity):
    if nonlinearity in ("relu", "leaky_relu"):
        return math.sqrt(2.0 / (1 + negative_slope ** 2))
    return 1.0


class KaimingNormal(Initializer):
    def __init__(self, fan_in=None, negative_slope=0.0, nonlinearity="relu"):
        self._fan_in, self.negative_slope, self.nonlinearity = fan_in, negative_slope, nonlinearity

    def __call__(self, shape, dtype):
        fi, _ = _fans(shape)
        fi = self._fan_in if self._fan_in is not None else fi
        std = _kaiming_gain(self.negative_slope, self.nonlinearity) / math.sqrt(fi)
        return (_normal(shape) * std).to(dtypes.convert_dtype(dtype))


class KaimingUniform(Initializer):
    def __init__(self, fan_in=None, negative_slope=0.0, nonlinearity="relu"):
        self._fan_in, self.negative_slope, self.nonlinearity = fan_in, negative_slope, nonlinearity

    def __call__(self, shape, dtype):
        fi, _ = _fans(shape)
        fi = self._fan_in if self._fan_in is not None else fi
        limit = _kaiming_gain(self.negative_slope, self.nonlinearity) * math.sqrt(3.0 / fi)
        return _uniform(shape, -limit, limit).to(dtypes.convert_dtype(dtype))


class Assign(Initializer):
    def __init__(self, value):
        self.value = value

    def __call__(self, shape, dtype):
        v = self.value._data if isinstance(self.value, Tensor) else \
            torch.as_tensor(np.asarray(self.value))
        return v.detach().to(device=current_device(),
                             dtype=dtypes.convert_dtype(dtype)).reshape(
                                 tuple(shape)).clone()


class Orthogonal(Initializer):
    """A (semi-)orthogonal matrix from the QR decomposition of a normal
    draw, signs fixed by R's diagonal (as ``jax.nn.initializers.orthogonal``
    builds it), over the shape flattened to [shape[0], rest]."""

    def __init__(self, gain=1.0):
        self.gain = gain

    def __call__(self, shape, dtype):
        shape = tuple(shape)
        rows = shape[0]
        cols = int(np.prod(shape[1:])) if len(shape) > 1 else 1
        a = _normal((max(rows, cols), min(rows, cols)))
        q, r = torch.linalg.qr(a)
        q = q * torch.sign(torch.diagonal(r))
        if rows < cols:
            q = q.T
        return (self.gain * q).reshape(shape).to(dtypes.convert_dtype(dtype))


class Dirac(Initializer):
    def __init__(self, groups=1):
        self.groups = groups

    def __call__(self, shape, dtype):
        arr = np.zeros(tuple(shape), np.float32)
        oc, ic = shape[0], shape[1]
        mins = min(oc // self.groups, ic)
        centers = [s // 2 for s in shape[2:]]
        for g in range(self.groups):
            for i in range(mins):
                arr[(g * (oc // self.groups) + i, i) + tuple(centers)] = 1.0
        return torch.from_numpy(arr).to(device=current_device(),
                                        dtype=dtypes.convert_dtype(dtype))


# paddle.ParamAttr analog
class ParamAttr:
    def __init__(self, name=None, initializer=None, learning_rate=1.0, regularizer=None,
                 trainable=True, do_model_average=True, need_clip=True):
        self.name = name
        self.initializer = initializer
        self.learning_rate = learning_rate
        self.regularizer = regularizer
        self.trainable = trainable
        self.need_clip = need_clip


def _resolve(attr, default_init):
    """Normalize a ParamAttr/Initializer/bool/None into (ParamAttr, Initializer)."""
    if attr is False:
        return None, None
    if attr is None:
        return ParamAttr(), default_init
    if isinstance(attr, Initializer):
        return ParamAttr(initializer=attr), attr
    if isinstance(attr, ParamAttr):
        return attr, attr.initializer or default_init
    if isinstance(attr, str):
        return ParamAttr(name=attr), default_init
    raise TypeError(f"bad param attr {attr!r}")
