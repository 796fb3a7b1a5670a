"""Quantized counterpart layers used by QAT/PTQ convert (reference:
python/paddle/nn/quant/qat/linear.py QuantedLinear,
paddle/nn/quant/format.py ConvertibleQuantedLayer).

TPU-native: a quanted layer shares the SAME weight/bias Parameter objects as
the float layer it replaces (no copy), applies fake-quant ops around the
original math, and converts to an int8-weight inference layer whose matmul
dequantizes per output channel.  Counterpart of
``paddle_tpu/quantization/qat_layers.py``: the inference product stays the
reference's plain ``(x @ qw) * s`` (a ``torch.matmul``; the reference leaves
it to XLA outside any Pallas kernel, so it does not take K8)."""
from __future__ import annotations

import torch

from ..core.tensor import Tensor
from ..core.dispatch import apply_op, unwrap
from ..nn.layer.layers import Layer
from ..nn import functional as F

__all__ = ["QuantedLinear", "QuantedConv2D", "QuantizedLinearInfer",
           "default_qat_mapping"]


def _make_quanters(config, layer, name=None):
    act_f, wt_f = config._get_config_by_layer(layer, name)
    act = act_f._instance(layer) if act_f is not None else None
    wt = wt_f._instance(layer) if wt_f is not None else None
    return act, wt


class QuantedLinear(Layer):
    """reference: nn/quant/qat/linear.py QuantedLinear."""

    def __init__(self, layer, q_config, name=None):
        super().__init__()
        self._float_layer = layer
        self.weight = layer.weight
        self.bias = layer.bias
        self.activation_quanter, self.weight_quanter = \
            _make_quanters(q_config, layer, name)

    def forward(self, x):
        # getattr: Layer.__setattr__(None) deletes a sublayer slot (PTQ
        # detaches the act quanter into an ObserveWrapper)
        aq = getattr(self, "activation_quanter", None)
        wq = getattr(self, "weight_quanter", None)
        if aq is not None:
            x = aq(x)
        w = self.weight if wq is None else wq(self.weight)
        return F.linear(x, w, self.bias)

    def weight_scales(self):
        wq = getattr(self, "weight_quanter", None)
        if wq is None:
            return None
        try:
            return wq.scales(self.weight)   # channel-wise: derive from weight
        except TypeError:
            return wq.scales()

    def convert(self):
        """-> int8-weight inference layer with fixed scales."""
        return QuantizedLinearInfer.from_float(
            self.weight, self.bias, self.weight_scales())


class QuantedConv2D(Layer):
    """reference: nn/quant/qat/conv.py QuantedConv2D."""

    def __init__(self, layer, q_config, name=None):
        super().__init__()
        self._float_layer = layer
        self.weight = layer.weight
        self.bias = layer.bias
        self.activation_quanter, self.weight_quanter = \
            _make_quanters(q_config, layer, name)

    def forward(self, x):
        aq = getattr(self, "activation_quanter", None)
        wq = getattr(self, "weight_quanter", None)
        if aq is not None:
            x = aq(x)
        w = self.weight if wq is None else wq(self.weight)
        l = self._float_layer
        return F.conv2d(x, w, self.bias, l._stride, l._padding, l._dilation,
                        l._groups, l._data_format)

    def convert(self):
        wq = getattr(self, "weight_quanter", None)
        scales = None
        if wq is not None:
            try:
                scales = wq.scales(self.weight)
            except TypeError:
                scales = wq.scales()
        return QuantizedConv2DInfer.from_float(self._float_layer, scales)


class QuantizedLinearInfer(Layer):
    """Inference layer: int8 weights + per-output-channel f32 scales.

    y = (x @ dequant(qw)) + b where dequant is a column-wise scale multiply;
    XLA folds the scale into the matmul epilogue (reference:
    phi weight_only_linear kernel)."""

    def __init__(self, qweight, scale, bias=None):
        super().__init__()
        self.register_buffer("qweight", Tensor(qweight))   # int8 [in, out]
        self.register_buffer("scale", Tensor(scale))       # f32 [out]
        self.bias = bias

    @staticmethod
    def from_float(weight, bias, scales=None, bits=8):
        w = unwrap(weight).detach()
        qmax = float(2 ** (bits - 1) - 1)
        if scales is None:
            s = torch.amax(torch.abs(w), dim=0) / qmax        # per out-col
        else:
            s = unwrap(scales) / qmax
            if s.ndim == 0:                                   # per-tensor
                s = s.reshape(1).expand(w.shape[-1]).contiguous()
            elif tuple(s.shape) != (w.shape[-1],):
                raise ValueError(
                    f"per-channel scales must index the OUTPUT channel "
                    f"(expected shape ({w.shape[-1]},), got "
                    f"{tuple(s.shape)}); for [in, out] Linear weights use "
                    f"quant_axis=1/-1")
        s = torch.clamp_min(s, 1e-9)
        qw = torch.clamp(torch.round(w / s[None, :]), -qmax,
                         qmax).to(torch.int8)
        return QuantizedLinearInfer(qw, s.to(torch.float32), bias)

    def forward(self, x):
        def f(a, qw, s, *b):
            y = (a @ qw.to(a.dtype)) * s.to(a.dtype)
            return y + b[0].to(a.dtype) if b else y
        args = (x, self.qweight, self.scale) + \
            ((self.bias,) if self.bias is not None else ())
        return apply_op("quantized_linear", f, *args)


class QuantizedConv2DInfer(Layer):
    """Inference conv: int8 weights [out, in, kh, kw] + per-out-channel f32
    scales; dequant is a per-channel multiply XLA fuses into the conv."""

    def __init__(self, qweight, scale, bias, conv_attrs):
        super().__init__()
        self.register_buffer("qweight", Tensor(qweight))
        self.register_buffer("scale", Tensor(scale))
        self.bias = bias
        self._attrs = conv_attrs

    @staticmethod
    def from_float(layer, scales=None, bits=8):
        w = unwrap(layer.weight).detach()        # [out, in, kh, kw]
        qmax = float(2 ** (bits - 1) - 1)
        if scales is None:
            s = torch.amax(torch.abs(w), dim=(1, 2, 3)) / qmax
        else:
            s = unwrap(scales) / qmax
            if s.ndim == 0:
                s = s.reshape(1).expand(w.shape[0]).contiguous()
            elif tuple(s.shape) != (w.shape[0],):
                raise ValueError(
                    f"conv per-channel scales must index the OUTPUT channel "
                    f"(expected shape ({w.shape[0]},), got "
                    f"{tuple(s.shape)}); use quant_axis=0 for "
                    f"[out, in, kh, kw] conv weights")
        s = torch.clamp_min(s, 1e-9)
        sb = s[:, None, None, None]
        qw = torch.clamp(torch.round(w / sb), -qmax, qmax).to(torch.int8)
        attrs = dict(stride=layer._stride, padding=layer._padding,
                     dilation=layer._dilation, groups=layer._groups,
                     data_format=layer._data_format)
        return QuantizedConv2DInfer(qw, s.to(torch.float32), layer.bias,
                                    attrs)

    def forward(self, x):
        if x.dtype != torch.float32:
            # the reference's conv refuses mixed operands the same way
            raise TypeError(
                f"lax.conv_general_dilated requires arguments to have the "
                f"same dtypes, got {x.dtype}, float32: QuantizedConv2DInfer "
                f"dequantizes its weights to float32")

        def dq(qw, s):
            return qw.to(torch.float32) * s[:, None, None, None]
        w = apply_op("conv_dequant", dq, self.qweight, self.scale)
        a = self._attrs
        return F.conv2d(x, w, self.bias, a["stride"], a["padding"],
                        a["dilation"], a["groups"], a["data_format"])


def default_qat_mapping():
    """Imported lazily so qat_layers doesn't circularly import nn at load."""
    from ..nn.layer.common import Linear
    from ..nn.layer.conv import Conv2D
    return {Linear: QuantedLinear, Conv2D: QuantedConv2D}
