"""Device selection for the port's entry points.

Every entry point (``LLMEngine``, ``ModelRunner``, ``LlamaForCausalLM``)
takes ``device=`` and defaults to the card.  Nothing carries on on the CPU
by itself: without CUDA, a caller that did not ask for the CPU gets an
error, never a silent slow path.
"""
from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a :class:`torch.device`; raises when it names CUDA and
    no card is present, or names a device type the port does not serve."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run the plain "
                "PyTorch path on the CPU")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev} (expected cuda or cpu)")
    return dev
