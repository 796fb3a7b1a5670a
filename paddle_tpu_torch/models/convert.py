"""Weight bridge: the JAX model's parameters, as numpy arrays keyed by its
``state_dict()`` names, into the port's :class:`~.llama.LlamaForCausalLM`.

Paddle's ``Linear`` stores its weight ``[in, out]``; torch's stores
``[out, in]``, so linear weights are transposed.  Embedding and norm
weights copy as they are.
"""
from __future__ import annotations

import numpy as np
import torch

from .llama import LlamaConfig, LlamaForCausalLM

__all__ = ["llama_from_numpy"]


def llama_from_numpy(state, config: LlamaConfig, device="cuda", dtype=None):
    """Build a :class:`LlamaForCausalLM` on ``device`` (in ``dtype``, default
    float32) holding ``state``'s weights.  Every model parameter must be in
    ``state`` with its JAX shape; unknown keys raise."""
    dtype = dtype or torch.float32
    model = LlamaForCausalLM(config, device=device, dtype=dtype)
    params = dict(model.named_parameters())
    missing = sorted(set(params) - set(state))
    extra = sorted(set(state) - set(params))
    if missing or extra:
        raise KeyError(f"state does not match the model: missing {missing}, "
                       f"unexpected {extra}")
    with torch.no_grad():
        for name, p in params.items():
            a = np.asarray(state[name], dtype=np.float32)
            if name.endswith("_proj.weight") or name == "lm_head.weight":
                a = a.T                                  # [in, out] -> [out, in]
            if tuple(a.shape) != tuple(p.shape):
                raise ValueError(f"{name}: got shape {a.shape} "
                                 f"({'transposed ' if a.ndim == 2 else ''}"
                                 f"from the state), expected "
                                 f"{tuple(p.shape)}")
            p.copy_(torch.from_numpy(np.array(a, order="C")))
    return model
