"""Pooling layers (reference: python/paddle/nn/layer/pooling.py)."""
from __future__ import annotations

from .layers import Layer
from .. import functional as F


def _mk_pool(name, fn, extra=()):
    class _P(Layer):
        def __init__(self, kernel_size, stride=None, padding=0, ceil_mode=False,
                     return_mask=False, exclusive=True, data_format=None, name_=None):
            super().__init__()
            self._args = dict(kernel_size=kernel_size, stride=stride, padding=padding)
            self._ceil = ceil_mode
            self._df = data_format
            self._return_mask = return_mask

        def forward(self, x):
            kw = dict(self._args)
            kw["ceil_mode"] = self._ceil
            if self._df:
                kw["data_format"] = self._df
            if self._return_mask and name.startswith("Max"):
                kw["return_mask"] = True
            return fn(x, **kw)
    _P.__name__ = name
    return _P


MaxPool1D = _mk_pool("MaxPool1D", F.max_pool1d)
MaxPool2D = _mk_pool("MaxPool2D", F.max_pool2d)
MaxPool3D = _mk_pool("MaxPool3D", F.max_pool3d)
AvgPool1D = _mk_pool("AvgPool1D", F.avg_pool1d)
AvgPool2D = _mk_pool("AvgPool2D", F.avg_pool2d)
AvgPool3D = _mk_pool("AvgPool3D", F.avg_pool3d)


class AdaptiveAvgPool1D(Layer):
    def __init__(self, output_size, name=None):
        super().__init__()
        self._os = output_size

    def forward(self, x):
        return F.adaptive_avg_pool1d(x, self._os)


class AdaptiveAvgPool2D(Layer):
    def __init__(self, output_size, data_format="NCHW", name=None):
        super().__init__()
        self._os, self._df = output_size, data_format

    def forward(self, x):
        return F.adaptive_avg_pool2d(x, self._os, self._df)


class AdaptiveAvgPool3D(Layer):
    def __init__(self, output_size, data_format="NCDHW", name=None):
        super().__init__()
        self._os, self._df = output_size, data_format

    def forward(self, x):
        return F.adaptive_avg_pool3d(x, self._os, self._df)


class AdaptiveMaxPool1D(Layer):
    def __init__(self, output_size, return_mask=False, name=None):
        super().__init__()
        self._os = output_size

    def forward(self, x):
        return F.adaptive_max_pool1d(x, self._os)


class AdaptiveMaxPool2D(Layer):
    def __init__(self, output_size, return_mask=False, name=None):
        super().__init__()
        self._os = output_size

    def forward(self, x):
        return F.adaptive_max_pool2d(x, self._os)


class AdaptiveMaxPool3D(Layer):
    def __init__(self, output_size, return_mask=False, name=None):
        super().__init__()
        self._os = output_size

    def forward(self, x):
        return F.adaptive_max_pool3d(x, self._os)


class MaxUnPool1D(Layer):
    """Inverse of MaxPool1D(return_mask=True) (reference: nn/layer/pooling.py
    MaxUnPool1D over the phi unpool kernel)."""

    def __init__(self, kernel_size, stride=None, padding=0, data_format="NCL",
                 output_size=None, name=None):
        super().__init__()
        self._kw = dict(kernel_size=kernel_size, stride=stride, padding=padding,
                        output_size=output_size)

    def forward(self, x, indices):
        return F.max_unpool1d(x, indices, **self._kw)


class MaxUnPool2D(Layer):
    """Inverse of MaxPool2D(return_mask=True)."""

    def __init__(self, kernel_size, stride=None, padding=0, data_format="NCHW",
                 output_size=None, name=None):
        super().__init__()
        self._kw = dict(kernel_size=kernel_size, stride=stride, padding=padding,
                        output_size=output_size)

    def forward(self, x, indices):
        return F.max_unpool2d(x, indices, **self._kw)
