"""Conv layers (reference: python/paddle/nn/layer/conv.py)."""
from __future__ import annotations

import numpy as np

from .layers import Layer
from .. import functional as F
from ..initializer import KaimingUniform, Uniform, Constant


def _ntuple(v, n):
    return tuple(v) if isinstance(v, (list, tuple)) else (v,) * n


class _ConvNd(Layer):
    def __init__(self, in_channels, out_channels, kernel_size, dims, stride=1, padding=0,
                 dilation=1, groups=1, padding_mode="zeros", weight_attr=None,
                 bias_attr=None, data_format="NCHW", transposed=False, output_padding=0):
        super().__init__()
        ks = _ntuple(kernel_size, dims)
        self._in_channels, self._out_channels = in_channels, out_channels
        self._kernel_size, self._stride = ks, _ntuple(stride, dims)
        self._padding, self._dilation = padding, _ntuple(dilation, dims)
        self._groups, self._data_format = groups, data_format
        self._transposed, self._output_padding = transposed, output_padding
        if transposed:
            w_shape = [in_channels, out_channels // groups, *ks]
        else:
            w_shape = [out_channels, in_channels // groups, *ks]
        fan_in = in_channels // groups * int(np.prod(ks))
        self.weight = self.create_parameter(
            w_shape, attr=weight_attr, default_initializer=KaimingUniform(fan_in=fan_in))
        bound = 1.0 / np.sqrt(fan_in)
        self.bias = self.create_parameter(
            [out_channels], attr=bias_attr, is_bias=True,
            default_initializer=Uniform(-bound, bound))

    def extra_repr(self):
        return (f"{self._in_channels}, {self._out_channels}, "
                f"kernel_size={list(self._kernel_size)}, stride={list(self._stride)}")


class Conv1D(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1, padding=0,
                 dilation=1, groups=1, padding_mode="zeros", weight_attr=None,
                 bias_attr=None, data_format="NCL"):
        super().__init__(in_channels, out_channels, kernel_size, 1, stride, padding,
                         dilation, groups, padding_mode, weight_attr, bias_attr, data_format)

    def forward(self, x):
        return F.conv1d(x, self.weight, self.bias, self._stride, self._padding,
                        self._dilation, self._groups, self._data_format)


class Conv2D(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1, padding=0,
                 dilation=1, groups=1, padding_mode="zeros", weight_attr=None,
                 bias_attr=None, data_format="NCHW"):
        super().__init__(in_channels, out_channels, kernel_size, 2, stride, padding,
                         dilation, groups, padding_mode, weight_attr, bias_attr, data_format)

    def forward(self, x):
        return F.conv2d(x, self.weight, self.bias, self._stride, self._padding,
                        self._dilation, self._groups, self._data_format)


class Conv3D(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1, padding=0,
                 dilation=1, groups=1, padding_mode="zeros", weight_attr=None,
                 bias_attr=None, data_format="NCDHW"):
        super().__init__(in_channels, out_channels, kernel_size, 3, stride, padding,
                         dilation, groups, padding_mode, weight_attr, bias_attr, data_format)

    def forward(self, x):
        return F.conv3d(x, self.weight, self.bias, self._stride, self._padding,
                        self._dilation, self._groups, self._data_format)


class Conv1DTranspose(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1, padding=0,
                 output_padding=0, groups=1, dilation=1, weight_attr=None,
                 bias_attr=None, data_format="NCL"):
        super().__init__(in_channels, out_channels, kernel_size, 1, stride, padding,
                         dilation, groups, "zeros", weight_attr, bias_attr, data_format,
                         transposed=True, output_padding=output_padding)

    def forward(self, x, output_size=None):
        return F.conv1d_transpose(x, self.weight, self.bias, self._stride, self._padding,
                                  self._output_padding, self._groups, self._dilation,
                                  output_size, self._data_format)


class Conv2DTranspose(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1, padding=0,
                 output_padding=0, groups=1, dilation=1, weight_attr=None,
                 bias_attr=None, data_format="NCHW"):
        super().__init__(in_channels, out_channels, kernel_size, 2, stride, padding,
                         dilation, groups, "zeros", weight_attr, bias_attr, data_format,
                         transposed=True, output_padding=output_padding)

    def forward(self, x, output_size=None):
        return F.conv2d_transpose(x, self.weight, self.bias, self._stride, self._padding,
                                  self._output_padding, self._groups, self._dilation,
                                  output_size, self._data_format)


class Conv3DTranspose(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1, padding=0,
                 output_padding=0, groups=1, dilation=1, weight_attr=None,
                 bias_attr=None, data_format="NCDHW"):
        super().__init__(in_channels, out_channels, kernel_size, 3, stride, padding,
                         dilation, groups, "zeros", weight_attr, bias_attr, data_format,
                         transposed=True, output_padding=output_padding)

    def forward(self, x, output_size=None):
        return F.conv3d_transpose(x, self.weight, self.bias, self._stride, self._padding,
                                  self._output_padding, self._groups, self._dilation,
                                  output_size, self._data_format)
