"""paddle.nn.quant analog (reference: python/paddle/nn/quant/quantized_linear
.py) — the serving-facing weight-only quantization API surface."""
from ...quantization.weight_only import (weight_quantize, weight_dequantize,
                                         weight_only_linear)
from ...quantization.qat_layers import QuantedLinear, QuantedConv2D

__all__ = ["weight_quantize", "weight_dequantize", "weight_only_linear",
           "QuantedLinear", "QuantedConv2D"]
