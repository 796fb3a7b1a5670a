"""paddle.nn.quant analog (reference: python/paddle/nn/quant/quantized_linear
.py): the serving-facing weight-only functions.  ``QuantedLinear`` and
``QuantedConv2D`` are not ported yet."""
from ...quantization.weight_only import (weight_dequantize,  # noqa: F401
                                         weight_only_linear, weight_quantize)

__all__ = ["weight_quantize", "weight_dequantize", "weight_only_linear"]
