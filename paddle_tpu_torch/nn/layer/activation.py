"""Activation layers (reference: python/paddle/nn/layer/activation.py)."""
from __future__ import annotations

from .layers import Layer
from .. import functional as F
from ..initializer import Constant


def _mk(name, fn, **defaults):
    def __init__(self, name_=None, **kw):
        Layer.__init__(self)
        self._kw = {**defaults, **kw}

    def forward(self, x):
        return fn(x, **self._kw)

    return type(name, (Layer,), {"__init__": __init__, "forward": forward})


ReLU = _mk("ReLU", F.relu)
ReLU6 = _mk("ReLU6", F.relu6)
Sigmoid = _mk("Sigmoid", F.sigmoid)
Tanh = _mk("Tanh", F.tanh)
Silu = _mk("Silu", F.silu)
Swish = _mk("Swish", F.silu)
Mish = _mk("Mish", F.mish)
Softsign = _mk("Softsign", F.softsign)
Tanhshrink = _mk("Tanhshrink", F.tanhshrink)
LogSigmoid = _mk("LogSigmoid", F.log_sigmoid)
Hardswish = _mk("Hardswish", F.hardswish)
SELU = _mk("SELU", F.selu)


class GELU(Layer):
    def __init__(self, approximate=False, name=None):
        super().__init__()
        self._approximate = approximate

    def forward(self, x):
        return F.gelu(x, approximate=self._approximate)


class LeakyReLU(Layer):
    def __init__(self, negative_slope=0.01, name=None):
        super().__init__()
        self._slope = negative_slope

    def forward(self, x):
        return F.leaky_relu(x, self._slope)


class ELU(Layer):
    def __init__(self, alpha=1.0, name=None):
        super().__init__()
        self._alpha = alpha

    def forward(self, x):
        return F.elu(x, self._alpha)


class CELU(Layer):
    def __init__(self, alpha=1.0, name=None):
        super().__init__()
        self._alpha = alpha

    def forward(self, x):
        return F.celu(x, self._alpha)


class Hardtanh(Layer):
    def __init__(self, min=-1.0, max=1.0, name=None):
        super().__init__()
        self._min, self._max = min, max

    def forward(self, x):
        return F.hardtanh(x, self._min, self._max)


class Hardsigmoid(Layer):
    def __init__(self, name=None):
        super().__init__()

    def forward(self, x):
        return F.hardsigmoid(x)


class Hardshrink(Layer):
    def __init__(self, threshold=0.5, name=None):
        super().__init__()
        self._t = threshold

    def forward(self, x):
        return F.hardshrink(x, self._t)


class Softshrink(Layer):
    def __init__(self, threshold=0.5, name=None):
        super().__init__()
        self._t = threshold

    def forward(self, x):
        return F.softshrink(x, self._t)


class Softplus(Layer):
    def __init__(self, beta=1, threshold=20, name=None):
        super().__init__()
        self._beta, self._threshold = beta, threshold

    def forward(self, x):
        return F.softplus(x, self._beta, self._threshold)


class Softmax(Layer):
    def __init__(self, axis=-1, name=None):
        super().__init__()
        self._axis = axis

    def forward(self, x):
        return F.softmax(x, axis=self._axis)


class LogSoftmax(Layer):
    def __init__(self, axis=-1, name=None):
        super().__init__()
        self._axis = axis

    def forward(self, x):
        return F.log_softmax(x, axis=self._axis)


class PReLU(Layer):
    def __init__(self, num_parameters=1, init=0.25, weight_attr=None,
                 data_format="NCHW", name=None):
        super().__init__()
        self._data_format = data_format
        self.weight = self.create_parameter([num_parameters], attr=weight_attr,
                                            default_initializer=Constant(init))

    def forward(self, x):
        return F.prelu(x, self.weight, self._data_format)


class RReLU(Layer):
    def __init__(self, lower=0.125, upper=0.3333333, name=None):
        super().__init__()
        self._lower, self._upper = lower, upper

    def forward(self, x):
        return F.rrelu(x, self._lower, self._upper, training=self.training)


class ThresholdedReLU(Layer):
    def __init__(self, threshold=1.0, value=0.0, name=None):
        super().__init__()
        self._threshold, self._value = threshold, value

    def forward(self, x):
        return F.thresholded_relu(x, self._threshold, self._value)


class Maxout(Layer):
    def __init__(self, groups, axis=1, name=None):
        super().__init__()
        self._groups, self._axis = groups, axis

    def forward(self, x):
        return F.maxout(x, self._groups, self._axis)


class GLU(Layer):
    def __init__(self, axis=-1, name=None):
        super().__init__()
        self._axis = axis

    def forward(self, x):
        return F.glu(x, self._axis)
