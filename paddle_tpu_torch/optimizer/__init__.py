"""Paddle's optimizers for torch parameters (counterpart of
``paddle_tpu/optimizer``): ``Adam`` and ``AdamW`` so far, with Paddle's
update rule rather than ``torch.optim``'s."""
from .optimizer import L1Decay, L2Decay, Optimizer  # noqa: F401
from .optimizers import Adam, AdamW  # noqa: F401

__all__ = ["Optimizer", "L1Decay", "L2Decay", "Adam", "AdamW"]
