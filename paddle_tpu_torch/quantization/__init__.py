"""paddle.quantization analog (reference: python/paddle/quantization — 3.9k
LoC: QuantConfig/QAT/PTQ + observers + quanters + imperative pass):
counterpart of ``paddle_tpu/quantization/__init__.py``.

QAT fake-quant is one autograd op (STE) that captures into one CUDA graph
under to_static; PTQ freezes to int8-weight layers; the weight-only
functions serve the bandwidth-bound decode case through K8."""
from .base import (BaseObserver, BaseQuanter, ObserverFactory, QuanterFactory,
                   quanter, fake_quant)
from .config import QuantConfig
from .observers import (AbsmaxObserver, AbsmaxObserverLayer,
                        PerChannelAbsmaxObserver,
                        PerChannelAbsmaxObserverLayer, HistObserver,
                        HistObserverLayer, KLObserver, KLObserverLayer)
from .quanters import (FakeQuanterWithAbsMaxObserver,
                       FakeQuanterWithAbsMaxObserverLayer,
                       FakeQuanterChannelWiseAbsMax,
                       FakeQuanterChannelWiseAbsMaxLayer)
from .qat_layers import (QuantedLinear, QuantedConv2D, QuantizedLinearInfer,
                         QuantizedConv2DInfer)
from .quantize import Quantization, QAT, PTQ, ObserveWrapper
from .weight_only import (weight_quantize, weight_dequantize,
                          weight_only_linear)

# imperative-API aliases (reference: quantization/imperative/ptq_quantizer.py)
AbsmaxQuantizer = AbsmaxObserver
PerChannelAbsmaxQuantizer = PerChannelAbsmaxObserver
HistQuantizer = HistObserver
KLQuantizer = KLObserver

__all__ = [
    "BaseObserver", "BaseQuanter", "ObserverFactory", "QuanterFactory",
    "quanter", "fake_quant", "QuantConfig", "AbsmaxObserver",
    "AbsmaxObserverLayer", "PerChannelAbsmaxObserver",
    "PerChannelAbsmaxObserverLayer", "HistObserver", "HistObserverLayer",
    "KLObserver", "KLObserverLayer", "FakeQuanterWithAbsMaxObserver",
    "FakeQuanterWithAbsMaxObserverLayer", "FakeQuanterChannelWiseAbsMax",
    "FakeQuanterChannelWiseAbsMaxLayer", "QuantedLinear", "QuantedConv2D",
    "QuantizedLinearInfer", "QuantizedConv2DInfer", "Quantization", "QAT",
    "PTQ", "ObserveWrapper",
    "weight_quantize", "weight_dequantize", "weight_only_linear",
    "AbsmaxQuantizer", "PerChannelAbsmaxQuantizer", "HistQuantizer",
    "KLQuantizer",
]
