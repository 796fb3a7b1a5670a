"""GPT-2 in PyTorch: the counterpart of ``paddle_tpu/models/gpt2.py``.

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

__all__ = ["GPT2Config", "GPT2ForCausalLM", "GPT2Model"]


class GPT2Config:
    def __init__(self, vocab_size=50304, hidden_size=768, num_layers=12,
                 num_heads=12, intermediate_size=None, max_position_embeddings=1024,
                 hidden_dropout_prob=0.1, attention_dropout_prob=0.1,
                 layer_norm_epsilon=1e-5, initializer_range=0.02,
                 use_recompute=False, loss_chunk_size=0,
                 loss_recompute=True, loss_logits_dtype="float32"):
        self.use_recompute = use_recompute
        self.loss_chunk_size = loss_chunk_size
        # recompute each chunk's logits in the backward instead of keeping
        # them: O(chunk * V) live memory for one more [chunk, V] product
        self.loss_recompute = loss_recompute
        # "bfloat16": keep the [chunk, V] logits in bf16 with an f32
        # log-sum-exp (half the bytes of the softmax pass)
        self.loss_logits_dtype = loss_logits_dtype
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.num_heads = num_heads
        self.intermediate_size = intermediate_size or 4 * hidden_size
        self.max_position_embeddings = max_position_embeddings
        self.hidden_dropout_prob = hidden_dropout_prob
        self.attention_dropout_prob = attention_dropout_prob
        self.layer_norm_epsilon = layer_norm_epsilon
        self.initializer_range = initializer_range

    @classmethod
    def gpt2_small(cls, **kw):  # 124M
        return cls(hidden_size=768, num_layers=12, num_heads=12, **kw)

    @classmethod
    def tiny(cls, **kw):  # test config
        kw.setdefault("vocab_size", 256)
        kw.setdefault("max_position_embeddings", 64)
        return cls(hidden_size=64, num_layers=2, num_heads=2, **kw)


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


def _chunk_loss(hc, w, yc, ignore_index, bf16_logits):
    """(sum of token losses, count of counted tokens) of one chunk: hidden
    [c, H] against the tied head w [V, H]; rows labelled ``ignore_index``
    (padding included) are left out of both."""
    valid = yc != ignore_index
    safe_y = torch.where(valid, yc, torch.zeros_like(yc)).long()[:, None]
    if bf16_logits:
        logits = (hc @ w.T).to(torch.bfloat16)           # [c, V] in bf16
        m = logits.amax(-1, keepdim=True)
        z = (logits - m).float()                         # f32 from here on
        lse = m[:, 0].float() + torch.log(torch.exp(z).sum(-1))
        picked = logits.gather(1, safe_y)[:, 0].float()
    else:
        logits = (hc @ w.T).float()
        lse = torch.logsumexp(logits, -1)
        picked = logits.gather(1, safe_y)[:, 0]
    per_tok = torch.where(valid, lse - picked, torch.zeros_like(lse))
    return per_tok.sum(), valid.sum()


def _chunked_lm_loss(hidden, wte, labels, chunk, ignore_index=-100,
                     recompute=True, logits_dtype="float32"):
    """Tied-head LM loss without [B * S, V] logits: a loop over token
    chunks of ``chunk`` rows (the reference's lax.scan), the last padded
    with ``ignore_index`` labels; with ``recompute`` each chunk is
    checkpointed, so the backward recomputes its [chunk, V] logits instead
    of keeping them.  ``logits_dtype="bfloat16"`` keeps the logits in bf16,
    subtracts the bf16 row max, then exponentiates and sums in f32.
    Returns the mean over counted tokens (float32)."""
    B, S, H = hidden.shape
    flat_h = hidden.reshape(B * S, H)
    flat_y = labels.reshape(B * S)
    n = flat_h.shape[0]
    c = min(chunk, n)
    pad = (-n) % c
    if pad:
        flat_h = F.pad(flat_h, (0, 0, 0, pad))
        flat_y = torch.cat([flat_y, flat_y.new_full((pad,), ignore_index)])
    bf16 = logits_dtype in ("bfloat16", torch.bfloat16)
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    count = torch.zeros((), dtype=torch.int64, device=hidden.device)
    for i in range(0, n + pad, c):
        args = (flat_h[i:i + c], wte, flat_y[i:i + c], ignore_index, bf16)
        t, k = (checkpoint(_chunk_loss, *args, use_reentrant=False)
                if recompute else _chunk_loss(*args))
        total = total + t
        count = count + k
    return total / count.clamp_min(1).float()


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
