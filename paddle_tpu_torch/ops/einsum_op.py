"""einsum: counterpart of ``paddle_tpu/ops/einsum_op.py`` (reference:
python/paddle/tensor/einsum.py), one dispatch of ``torch.einsum``."""
from __future__ import annotations

import torch

from ..core.dispatch import apply_op


def einsum(equation, *operands):
    return apply_op("einsum", lambda *arrs: torch.einsum(equation, *arrs),
                    *operands)
