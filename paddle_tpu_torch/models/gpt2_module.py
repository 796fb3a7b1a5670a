"""GPT-2 as a ``torch.nn.Module``: the yardstick the ``Layer`` model of
:mod:`.gpt2` (the counterpart of ``paddle_tpu/models/gpt2.py``) is held to.

``GPT2ForCausalLM`` is an ``nn.Module`` whose parameter names equal the JAX
model's ``state_dict()`` keys (``gpt2.wte.weight``, ``gpt2.wpe.weight``,
``gpt2.blocks.{i}.{ln1,attn.qkv,attn.proj,ln2,mlp.fc,mlp.proj}.*``,
``gpt2.ln_f.*``), so weights cross between the packages by name (see
:mod:`.convert`); Linear weights are stored the torch way, ``[out, in]``.
The LM head is tied to ``wte``.  Attention goes through
:func:`~paddle_tpu_torch.nn.functional.scaled_dot_product_attention`, so a
training step on the card runs the flash kernels K1 (forward) and K2 + K3
(backward) at every layer.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..device import resolve_device
from ..nn.functional import cross_entropy, scaled_dot_product_attention
from .gpt2 import GPT2Config, _chunked_lm_loss

__all__ = ["GPT2Config", "GPT2ForCausalLM", "GPT2Model"]


class GPT2Attention(nn.Module):
    def __init__(self, config: GPT2Config, device=None, dtype=None):
        super().__init__()
        h = config.hidden_size
        self.num_heads = config.num_heads
        self.head_dim = h // config.num_heads
        self.qkv = nn.Linear(h, 3 * h, device=device, dtype=dtype)
        self.proj = nn.Linear(h, h, device=device, dtype=dtype)
        self.attn_drop = config.attention_dropout_prob
        self.resid_drop = nn.Dropout(config.hidden_dropout_prob)

    def forward(self, x):
        b, s, h = x.shape
        qkv = self.qkv(x).view(b, s, 3, self.num_heads, self.head_dim)
        q, k, v = qkv.unbind(2)
        out = scaled_dot_product_attention(
            q, k, v, is_causal=True, dropout_p=self.attn_drop,
            training=self.training)
        return self.resid_drop(self.proj(out.reshape(b, s, h)))


class GPT2MLP(nn.Module):
    def __init__(self, config: GPT2Config, device=None, dtype=None):
        super().__init__()
        h, m = config.hidden_size, config.intermediate_size
        self.fc = nn.Linear(h, m, device=device, dtype=dtype)
        self.proj = nn.Linear(m, h, device=device, dtype=dtype)
        self.drop = nn.Dropout(config.hidden_dropout_prob)

    def forward(self, x):
        return self.drop(self.proj(F.gelu(self.fc(x), approximate="tanh")))


class GPT2Block(nn.Module):
    def __init__(self, config: GPT2Config, device=None, dtype=None):
        super().__init__()
        h, eps = config.hidden_size, config.layer_norm_epsilon
        self.ln1 = nn.LayerNorm(h, eps=eps, device=device, dtype=dtype)
        self.attn = GPT2Attention(config, device, dtype)
        self.ln2 = nn.LayerNorm(h, eps=eps, device=device, dtype=dtype)
        self.mlp = GPT2MLP(config, device, dtype)

    def forward(self, x):
        x = x + self.attn(self.ln1(x))
        return x + self.mlp(self.ln2(x))


class GPT2Model(nn.Module):
    def __init__(self, config: GPT2Config, device=None, dtype=None):
        super().__init__()
        self.config = config
        h = config.hidden_size
        self.wte = nn.Embedding(config.vocab_size, h, device=device,
                                dtype=dtype)
        self.wpe = nn.Embedding(config.max_position_embeddings, h,
                                device=device, dtype=dtype)
        self.drop = nn.Dropout(config.hidden_dropout_prob)
        self.blocks = nn.ModuleList([GPT2Block(config, device, dtype)
                                     for _ in range(config.num_layers)])
        self.ln_f = nn.LayerNorm(h, eps=config.layer_norm_epsilon,
                                 device=device, dtype=dtype)

    def forward(self, input_ids, position_ids=None):
        s = input_ids.shape[1]
        if position_ids is None:
            position_ids = torch.arange(s, device=input_ids.device)[None]
        x = self.drop(self.wte(input_ids) + self.wpe(position_ids))
        remat = self.config.use_recompute and self.training
        for block in self.blocks:
            x = checkpoint(block, x, use_reentrant=False) if remat else \
                block(x)
        return self.ln_f(x)


class GPT2ForCausalLM(nn.Module):
    """GPT-2 causal LM with the head tied to ``wte``.  ``device`` defaults
    to the card (raises without CUDA unless ``device="cpu"``).  The weights
    are drawn as the JAX layers draw them — Linear and embedding weights
    N(0, initializer_range), the two ``proj`` weights of each block
    N(0, initializer_range / sqrt(2 * num_layers)), biases 0, LayerNorm
    weights 1 — from ``generator`` (torch's default when None), in
    parameter order, on the model's device."""

    def __init__(self, config: GPT2Config = None, device="cuda", dtype=None,
                 generator=None):
        super().__init__()
        dev = resolve_device(device)
        self.config = config = config or GPT2Config()
        self.gpt2 = GPT2Model(config, dev, dtype)
        self.init_weights(generator)

    @torch.no_grad()
    def init_weights(self, generator=None):
        std = self.config.initializer_range
        proj_std = std / math.sqrt(2 * self.config.num_layers)
        for name, p in self.named_parameters():
            if name.endswith(".bias"):
                p.zero_()
            elif ".ln" in name:
                p.fill_(1.0)
            else:
                p.normal_(0.0, proj_std if name.endswith("proj.weight")
                          else std, generator=generator)

    @property
    def device(self):
        return self.gpt2.wte.weight.device

    def forward(self, input_ids, labels=None, position_ids=None):
        """Logits [B, S, V] in the model's dtype; with ``labels``
        ``(logits, loss)``, or ``(None, loss)`` when
        ``config.loss_chunk_size`` streams the loss in chunks.  Labels are
        the targets of each position as given (no shift), -100 ignored."""
        cfg = self.config
        hidden = self.gpt2(input_ids, position_ids)
        w = self.gpt2.wte.weight
        if labels is not None and cfg.loss_chunk_size:
            return None, _chunked_lm_loss(
                hidden, w, labels, cfg.loss_chunk_size,
                recompute=cfg.loss_recompute,
                logits_dtype=cfg.loss_logits_dtype)
        logits = hidden @ w.T
        if labels is not None:
            return logits, cross_entropy(logits.reshape(-1, cfg.vocab_size),
                                         labels.reshape(-1))
        return logits
