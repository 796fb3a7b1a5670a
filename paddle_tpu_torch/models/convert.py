"""Weight bridge: the JAX model's parameters, as numpy arrays keyed by its
``state_dict()`` names, into the port's :class:`~.llama_module.LlamaForCausalLM`
and :class:`~.gpt2_module.GPT2ForCausalLM` (the ``torch.nn`` GPT-2).

Paddle's ``Linear`` stores its weight ``[in, out]``; torch's stores
``[out, in]``, so linear weights are transposed.  Embedding and norm
weights copy as they are.
"""
from __future__ import annotations

import numpy as np
import torch

from .gpt2 import GPT2Config
from .gpt2_module import GPT2ForCausalLM
from .llama_module import LlamaConfig, LlamaForCausalLM

__all__ = ["llama_from_numpy", "gpt2_from_numpy", "gpt2_linear"]


def _load(model, state, is_linear):
    """Copy ``state`` into ``model``'s parameters by name, transposing the
    Linear weights (``is_linear(name)``); every parameter must be there
    with its JAX shape, and unknown keys raise."""
    params = dict(model.named_parameters())
    missing = sorted(set(params) - set(state))
    extra = sorted(set(state) - set(params))
    if missing or extra:
        raise KeyError(f"state does not match the model: missing {missing}, "
                       f"unexpected {extra}")
    with torch.no_grad():
        for name, p in params.items():
            a = np.asarray(state[name], dtype=np.float32)
            if is_linear(name):
                a = a.T                                  # [in, out] -> [out, in]
            if tuple(a.shape) != tuple(p.shape):
                raise ValueError(f"{name}: got shape {a.shape} "
                                 f"({'transposed ' if a.ndim == 2 else ''}"
                                 f"from the state), expected "
                                 f"{tuple(p.shape)}")
            p.copy_(torch.from_numpy(np.array(a, order="C")))
    return model


def llama_from_numpy(state, config: LlamaConfig, device="cuda", dtype=None):
    """Build a :class:`LlamaForCausalLM` on ``device`` (in ``dtype``, default
    float32) holding ``state``'s weights.  Every model parameter must be in
    ``state`` with its JAX shape; unknown keys raise."""
    model = LlamaForCausalLM(config, device=device,
                             dtype=dtype or torch.float32)
    return _load(model, state, lambda n: n.endswith("_proj.weight")
                 or n == "lm_head.weight")


def gpt2_linear(name):
    """Whether GPT-2's parameter ``name`` is a Linear weight (stored
    ``[in, out]`` by the JAX model, ``[out, in]`` by the port's)."""
    return name.endswith(".weight") and name not in (
        "gpt2.wte.weight", "gpt2.wpe.weight") and ".ln" not in name


def gpt2_from_numpy(state, config: GPT2Config, device="cuda", dtype=None):
    """Build a :class:`GPT2ForCausalLM` on ``device`` (in ``dtype``, default
    float32) holding ``state``'s weights: Linear weights transposed, biases,
    LayerNorm weights and the two embeddings copied as they are.  Every
    model parameter must be in ``state`` with its JAX shape; unknown keys
    raise."""
    model = GPT2ForCausalLM(config, device=device,
                            dtype=dtype or torch.float32)
    return _load(model, state, gpt2_linear)
