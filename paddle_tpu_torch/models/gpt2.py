"""GPT-2 on ``nn.Layer``: counterpart of ``paddle_tpu/models/gpt2.py``
(BASELINE config #1: 124M single-chip LM pretraining).

Architecture parity target: PaddleNLP GPT-2 (the reference repo hosts the
framework; the model recipe lives downstream). Built purely from the
port's ``nn`` so it exercises the user-facing stack end to end: the same
classes, parameter names and ``GPT2Config`` as the reference, with
``Linear`` weights ``[in, out]``, so the JAX model's ``state_dict`` loads
through ``set_state_dict`` unchanged.  Attention is
``F.scaled_dot_product_attention`` (K1-K3 on the card, K4 under
``FLAGS_flash_layout_direct``).  The chunked loss is one ``apply_op`` of
:func:`_chunked_lm_loss_body`, which the ``torch.nn`` model of
:mod:`.gpt2_module` calls on torch tensors directly.  Not ported yet:
``use_recompute`` (``fleet.recompute``, M12), which raises.  ``generate``
is the reference's loop (``ops.topk``, ``ops.multinomial``): each step
runs the whole context, so only a context of a multiple of 128 tokens
takes the flash kernels.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as TF
from torch.utils.checkpoint import checkpoint

from .. import ops
from ..core.tensor import Tensor
from ..nn.layer.layers import Layer
from ..nn.layer.common import Linear, Embedding, Dropout
from ..nn.layer.norm import LayerNorm
from ..nn.layer.container import LayerList
from ..nn import functional as F
from ..nn.initializer import Normal


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
        # log-sum-exp (half the bytes of the softmax pass and of what the
        # backward keeps when loss_recompute is off)
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


class GPT2Attention(Layer):
    def __init__(self, config: GPT2Config):
        super().__init__()
        self.num_heads = config.num_heads
        self.head_dim = config.hidden_size // config.num_heads
        init = Normal(std=config.initializer_range)
        self.qkv = Linear(config.hidden_size, 3 * config.hidden_size,
                          weight_attr=init)
        self.proj = Linear(config.hidden_size, config.hidden_size,
                           weight_attr=Normal(std=config.initializer_range /
                                              math.sqrt(2 * config.num_layers)))
        self.attn_drop = config.attention_dropout_prob
        self.resid_drop = Dropout(config.hidden_dropout_prob)

    def forward(self, x):
        b, s, h = x.shape
        qkv = self.qkv(x).reshape([b, s, 3, self.num_heads, self.head_dim])
        q, k, v = qkv.unbind(axis=2)
        out = F.scaled_dot_product_attention(
            q, k, v, is_causal=True, dropout_p=self.attn_drop,
            training=self.training)
        out = out.reshape([b, s, h])
        return self.resid_drop(self.proj(out))


class GPT2MLP(Layer):
    def __init__(self, config: GPT2Config):
        super().__init__()
        init = Normal(std=config.initializer_range)
        self.fc = Linear(config.hidden_size, config.intermediate_size, weight_attr=init)
        self.proj = Linear(config.intermediate_size, config.hidden_size,
                           weight_attr=Normal(std=config.initializer_range /
                                              math.sqrt(2 * config.num_layers)))
        self.drop = Dropout(config.hidden_dropout_prob)

    def forward(self, x):
        return self.drop(self.proj(F.gelu(self.fc(x), approximate=True)))


class GPT2Block(Layer):
    def __init__(self, config: GPT2Config):
        super().__init__()
        self.ln1 = LayerNorm(config.hidden_size, epsilon=config.layer_norm_epsilon)
        self.attn = GPT2Attention(config)
        self.ln2 = LayerNorm(config.hidden_size, epsilon=config.layer_norm_epsilon)
        self.mlp = GPT2MLP(config)

    def forward(self, x):
        x = x + self.attn(self.ln1(x))
        x = x + self.mlp(self.ln2(x))
        return x


class GPT2Model(Layer):
    def __init__(self, config: GPT2Config):
        super().__init__()
        self.config = config
        init = Normal(std=config.initializer_range)
        self.wte = Embedding(config.vocab_size, config.hidden_size, weight_attr=init)
        self.wpe = Embedding(config.max_position_embeddings, config.hidden_size,
                             weight_attr=Normal(std=config.initializer_range))
        self.drop = Dropout(config.hidden_dropout_prob)
        self.blocks = LayerList([GPT2Block(config) for _ in range(config.num_layers)])
        self.ln_f = LayerNorm(config.hidden_size, epsilon=config.layer_norm_epsilon)

    def forward(self, input_ids, position_ids=None):
        b, s = input_ids.shape
        if position_ids is None:
            position_ids = ops.arange(s, dtype="int64").unsqueeze(0)
        x = self.wte(input_ids) + self.wpe(position_ids)
        x = self.drop(x)
        remat = self.config.use_recompute and self.training
        if remat:
            raise NotImplementedError(
                "use_recompute needs fleet.recompute, which the port does not "
                "have yet (M12)")
        for block in self.blocks:
            x = block(x)
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


def _chunked_lm_loss_body(hidden, wte, labels, chunk, ignore_index=-100,
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
        flat_h = TF.pad(flat_h, (0, 0, 0, pad))
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


def _chunked_lm_loss(hidden, wte, labels, chunk, ignore_index=-100,
                     recompute=True, logits_dtype="float32"):
    """Tied-head LM loss WITHOUT materializing [B*S, V] logits (see
    :func:`_chunked_lm_loss_body`): one dispatch for port Tensors, the body
    itself for torch tensors."""
    def f(h, w, y):
        return _chunked_lm_loss_body(h, w, y, chunk, ignore_index, recompute,
                                     logits_dtype)
    if not isinstance(hidden, Tensor):
        return f(hidden, wte, labels)
    from ..core.dispatch import apply_op
    return apply_op("chunked_lm_loss", f, hidden, wte, labels)


class GPT2ForCausalLM(Layer):
    """LM head ties wte weights (standard GPT-2)."""

    def __init__(self, config: GPT2Config):
        super().__init__()
        self.gpt2 = GPT2Model(config)
        self.config = config

    def forward(self, input_ids, labels=None, position_ids=None):
        hidden = self.gpt2(input_ids, position_ids)
        if labels is not None and self.config.loss_chunk_size:
            loss = _chunked_lm_loss(
                hidden, self.gpt2.wte.weight, labels,
                self.config.loss_chunk_size,
                recompute=self.config.loss_recompute,
                logits_dtype=getattr(self.config, "loss_logits_dtype",
                                     "float32"))
            return None, loss
        logits = ops.matmul(hidden, self.gpt2.wte.weight, transpose_y=True)
        if labels is not None:
            loss = F.cross_entropy(
                logits.reshape([-1, self.config.vocab_size]),
                labels.reshape([-1]))
            return logits, loss
        return logits

    def generate(self, input_ids, max_new_tokens=20, temperature=1.0, top_k=None):
        from .. import no_grad
        out = input_ids
        with no_grad():
            self.eval()
            for _ in range(max_new_tokens):
                ctx = out if out.shape[1] <= self.config.max_position_embeddings \
                    else out[:, -self.config.max_position_embeddings:]
                logits = self.forward(ctx)
                nxt = logits[:, -1, :] / temperature
                if top_k is not None:
                    v, _ = ops.topk(nxt, top_k)
                    nxt = ops.where(nxt < v[:, -1:], ops.full_like(nxt, -1e30), nxt)
                probs = F.softmax(nxt, axis=-1)
                token = ops.multinomial(probs, 1)
                out = ops.concat([out, token], axis=1)
        return out



def gpt2_small():
    return GPT2ForCausalLM(GPT2Config.gpt2_small())


def gpt2_tiny():
    return GPT2ForCausalLM(GPT2Config.tiny())
