"""Token cross-entropy: counterpart of the hard-label, mean-reduced case of
``paddle_tpu/nn/functional/loss.py::cross_entropy``."""
from __future__ import annotations

import torch

__all__ = ["cross_entropy"]


def cross_entropy(input, label, ignore_index=-100):
    """Mean negative log-likelihood of ``label`` [N] under the logits
    ``input`` [N, C], computed in float32; rows whose label is
    ``ignore_index`` count neither in the sum nor in the mean's count (all
    ignored gives 0, as the reference's clamped denominator does)."""
    logp = torch.log_softmax(input.float(), dim=-1)
    valid = label != ignore_index
    safe = torch.where(valid, label, torch.zeros_like(label)).long()
    picked = logp.gather(-1, safe[:, None])[:, 0]
    loss = torch.where(valid, -picked, torch.zeros_like(picked))
    return loss.sum() / valid.sum().float().clamp_min(1e-12)
