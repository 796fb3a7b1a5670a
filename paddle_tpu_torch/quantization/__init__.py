"""paddle.quantization, as far as the port has it: the weight-only
functions (counterpart of ``paddle_tpu/quantization``).  QAT, PTQ, the
observers and quanters and the quantized layers are not ported yet."""
from .weight_only import (weight_dequantize, weight_only_linear,  # noqa: F401
                          weight_quantize)

__all__ = ["weight_quantize", "weight_dequantize", "weight_only_linear"]
