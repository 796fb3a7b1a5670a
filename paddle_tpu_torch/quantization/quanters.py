"""Trainable fake quanters for QAT (reference:
python/paddle/quantization/quanters/abs_max.py
FakeQuanterWithAbsMaxObserverLayer).

Counterpart of ``paddle_tpu/quantization/quanters.py``: the EMA scale is a
Layer buffer (a Tensor) rebound each training step, so when a QAT train
step is captured by to_static the rebinding is copied back into the graph's
storage after each replay — the whole QAT step stays ONE CUDA graph.  The
EMA reads its input detached: it is state, not part of the tape."""
from __future__ import annotations

import numpy as np
import torch

from ..core.tensor import Tensor
from ..core.dispatch import apply_op, unwrap
from .base import BaseQuanter, QuanterFactory, fake_quant

__all__ = ["FakeQuanterWithAbsMaxObserver",
           "FakeQuanterWithAbsMaxObserverLayer",
           "FakeQuanterChannelWiseAbsMax",
           "FakeQuanterChannelWiseAbsMaxLayer"]


class FakeQuanterWithAbsMaxObserverLayer(BaseQuanter):
    """Moving-average absmax scale + fake quant with STE
    (reference: quanters/abs_max.py:96 dynamic_forward)."""

    def __init__(self, layer=None, moving_rate=0.9, bit_length=8, dtype=None,
                 name=None):
        super().__init__()
        self._rate = moving_rate
        self._bits = bit_length
        self._qmax = float(2 ** (bit_length - 1) - 1)
        self.register_buffer("scale", Tensor(np.asarray(0.0, np.float32)))
        self.register_buffer("state", Tensor(np.asarray(0.0, np.float32)))

    def forward(self, x):
        if self.training:
            def upd(a, sc, st):
                absmax = torch.max(torch.abs(a.detach())).to(torch.float32)
                st2 = st * self._rate + 1.0
                sc2 = (sc * self._rate * st + absmax) / st2
                return sc2, st2
            sc2, st2 = apply_op("fq_absmax_update", upd, x, self.scale,
                                self.state)
            self.scale._data = unwrap(sc2)
            self.state._data = unwrap(st2)
        qmax = self._qmax

        def fq(a, s):
            return fake_quant(a, s, qmax)
        return apply_op("fake_quant_absmax", fq, x, self.scale)

    def bit_length(self):
        return self._bits

    def scales(self):
        return self.scale


class FakeQuanterChannelWiseAbsMaxLayer(BaseQuanter):
    """Per-channel absmax fake quanter for weights (reference:
    quanters/abs_max.py channel-wise path; quant_axis = output channel)."""

    def __init__(self, layer=None, bit_length=8, quant_axis=-1, dtype=None,
                 name=None):
        super().__init__()
        self._bits = bit_length
        self._axis = quant_axis
        self._qmax = float(2 ** (bit_length - 1) - 1)

    def forward(self, x):
        axis = self._axis % x.ndim
        qmax = self._qmax

        def fq(a):
            axes = tuple(i for i in range(a.ndim) if i != axis)
            s = torch.amax(torch.abs(a.detach()), dim=axes, keepdim=True)
            shape = [1] * a.ndim
            shape[axis] = a.shape[axis]
            return fake_quant(a, s.reshape(shape), qmax)
        return apply_op("fake_quant_channel", fq, x)

    def bit_length(self):
        return self._bits

    def quant_axis(self):
        return self._axis

    def scales(self, x):
        """Scale is a pure function of the quantized tensor (per-channel
        absmax), so it's derived on demand from a concrete tensor rather
        than cached in forward — caching there would leak tracers when the
        forward runs under to_static capture."""
        a = torch.abs(unwrap(x).detach())
        axis = self._axis % a.ndim
        axes = tuple(i for i in range(a.ndim) if i != axis)
        return Tensor(torch.amax(a, dim=axes).to(torch.float32))


class FakeQuanterWithAbsMaxObserver(QuanterFactory):
    def _get_class(self):
        return FakeQuanterWithAbsMaxObserverLayer


class FakeQuanterChannelWiseAbsMax(QuanterFactory):
    def _get_class(self):
        return FakeQuanterChannelWiseAbsMaxLayer
