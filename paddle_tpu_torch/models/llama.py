"""Llama-3 family in PyTorch: the counterpart of ``paddle_tpu/models/llama.py``.

``LlamaForCausalLM`` is an ``nn.Module`` whose parameter names equal the JAX
model's ``state_dict()`` keys (``llama.embed_tokens.weight``,
``llama.layers.{i}.self_attn.q_proj.weight``, ..., ``lm_head.weight``), so
weights cross between the packages by name (see :mod:`.convert`).  Linear
weights are stored the torch way, ``[out, in]``.

This slice carries the serving engine, which reads the weights directly;
the model's own dense forward is :meth:`LlamaForCausalLM.forward_ref`, a
plain PyTorch reference.  ``forward`` on a CUDA tensor waits for the
flash-attention forward kernel (K1); ``generate``, ``KVCache``, MoE and the
pipeline stage classes wait too.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device

__all__ = ["LlamaConfig", "LlamaForCausalLM", "rope", "rms_norm"]


class LlamaConfig:
    def __init__(self, vocab_size=128256, hidden_size=4096, intermediate_size=14336,
                 num_hidden_layers=32, num_attention_heads=32, num_key_value_heads=8,
                 max_position_embeddings=8192, rms_norm_eps=1e-5, rope_theta=500000.0,
                 tie_word_embeddings=False, initializer_range=0.02,
                 num_experts=0, num_experts_per_tok=2, moe_intermediate_size=None,
                 sep_backend="ring"):
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.intermediate_size = intermediate_size
        self.num_hidden_layers = num_hidden_layers
        self.num_attention_heads = num_attention_heads
        self.num_key_value_heads = num_key_value_heads
        self.max_position_embeddings = max_position_embeddings
        self.rms_norm_eps = rms_norm_eps
        self.rope_theta = rope_theta
        self.tie_word_embeddings = tie_word_embeddings
        self.initializer_range = initializer_range
        self.num_experts = num_experts
        self.sep_backend = sep_backend
        self.num_experts_per_tok = num_experts_per_tok
        self.moe_intermediate_size = moe_intermediate_size

    @classmethod
    def llama3_8b(cls, **kw):
        return cls(**kw)

    @classmethod
    def qwen2_moe_a14b(cls, **kw):
        """Qwen2-57B-A14B MoE geometry (public config: 64 experts, top-8,
        GQA 28q/4kv, 3584 hidden) — BASELINE config #5 family."""
        kw.setdefault("vocab_size", 151936)
        kw.setdefault("hidden_size", 3584)
        kw.setdefault("intermediate_size", 18944)
        kw.setdefault("num_hidden_layers", 28)
        kw.setdefault("num_attention_heads", 28)
        kw.setdefault("num_key_value_heads", 4)
        kw.setdefault("max_position_embeddings", 32768)
        kw.setdefault("rope_theta", 1000000.0)
        kw.setdefault("num_experts", 64)
        kw.setdefault("num_experts_per_tok", 8)
        kw.setdefault("moe_intermediate_size", 2560)
        return cls(**kw)

    @classmethod
    def deepseek_moe_16b(cls, **kw):
        """DeepSeekMoE-16B geometry (public config: 64 routed experts, top-6,
        2048 hidden, 1408 moe-ffn) — BASELINE config #5 family."""
        kw.setdefault("vocab_size", 102400)
        kw.setdefault("hidden_size", 2048)
        kw.setdefault("intermediate_size", 10944)
        kw.setdefault("num_hidden_layers", 28)
        kw.setdefault("num_attention_heads", 16)
        kw.setdefault("num_key_value_heads", 16)
        kw.setdefault("max_position_embeddings", 4096)
        kw.setdefault("rope_theta", 10000.0)
        kw.setdefault("num_experts", 64)
        kw.setdefault("num_experts_per_tok", 6)
        kw.setdefault("moe_intermediate_size", 1408)
        return cls(**kw)

    @classmethod
    def tiny(cls, **kw):
        kw.setdefault("vocab_size", 256)
        kw.setdefault("hidden_size", 64)
        kw.setdefault("intermediate_size", 128)
        kw.setdefault("num_hidden_layers", 2)
        kw.setdefault("num_attention_heads", 4)
        kw.setdefault("num_key_value_heads", 2)
        kw.setdefault("max_position_embeddings", 128)
        kw.setdefault("rope_theta", 10000.0)
        return cls(**kw)

    @classmethod
    def tiny_moe(cls, **kw):
        kw.setdefault("num_experts", 4)
        return cls.tiny(**kw)


def rms_norm(x, weight, eps):
    """RMSNorm computed in float32, cast back to x's dtype."""
    xf = x.float()
    var = xf.pow(2).mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * weight.float()).to(x.dtype)


def rope(x, pos, theta):
    """neox-style RoPE in float32: x [..., N, Hn, D] at integer positions
    pos [..., N] (the formulation of ``nn/functional/rope.py``)."""
    D = x.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, D, 2, dtype=torch.float32,
                                        device=x.device) / D))
    freqs = pos.float()[..., None] * inv                    # [..., N, D/2]
    emb = torch.cat([freqs, freqs], dim=-1)[..., None, :]   # [..., N, 1, D]
    xf = x.float()
    half = D // 2
    rot = torch.cat([-xf[..., half:], xf[..., :half]], dim=-1)
    return (xf * torch.cos(emb) + rot * torch.sin(emb)).to(x.dtype)


class RMSNorm(nn.Module):
    def __init__(self, hidden_size, eps, device=None, dtype=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(hidden_size, device=device,
                                              dtype=dtype))

    def forward(self, x):
        return rms_norm(x, self.weight, self.eps)


def _linear(n_in, n_out, device, dtype):
    return nn.Linear(n_in, n_out, bias=False, device=device, dtype=dtype)


class LlamaAttention(nn.Module):
    def __init__(self, config: LlamaConfig, device=None, dtype=None):
        super().__init__()
        h = config.hidden_size
        self.num_heads = config.num_attention_heads
        self.num_kv_heads = config.num_key_value_heads
        self.head_dim = h // self.num_heads
        self.rope_theta = config.rope_theta
        self.q_proj = _linear(h, self.num_heads * self.head_dim, device, dtype)
        self.k_proj = _linear(h, self.num_kv_heads * self.head_dim, device,
                              dtype)
        self.v_proj = _linear(h, self.num_kv_heads * self.head_dim, device,
                              dtype)
        self.o_proj = _linear(self.num_heads * self.head_dim, h, device, dtype)

    def forward_ref(self, x):
        """Dense causal GQA attention over x [B, S, hidden], float32 softmax."""
        b, s, _ = x.shape
        nh, kvh, d = self.num_heads, self.num_kv_heads, self.head_dim
        q = self.q_proj(x).view(b, s, nh, d)
        k = self.k_proj(x).view(b, s, kvh, d)
        v = self.v_proj(x).view(b, s, kvh, d)
        pos = torch.arange(s, device=x.device)
        q, k = rope(q, pos, self.rope_theta), rope(k, pos, self.rope_theta)
        g = nh // kvh
        qf = q.float().view(b, s, kvh, g, d)
        sc = torch.einsum("bskgd,btkd->bkgst", qf, k.float()) / d ** 0.5
        causal = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()
        sc = sc.masked_fill(~causal, float("-inf"))
        p = torch.softmax(sc, dim=-1)
        out = torch.einsum("bkgst,btkd->bskgd", p, v.float())
        return self.o_proj(out.reshape(b, s, nh * d).to(x.dtype))


class LlamaMLP(nn.Module):
    def __init__(self, config: LlamaConfig, device=None, dtype=None):
        super().__init__()
        h, m = config.hidden_size, config.intermediate_size
        self.gate_proj = _linear(h, m, device, dtype)
        self.up_proj = _linear(h, m, device, dtype)
        self.down_proj = _linear(m, h, device, dtype)

    def forward(self, x):
        up = self.up_proj(x)
        return self.down_proj(
            F.silu(self.gate_proj(x).float()).to(up.dtype) * up)


class LlamaDecoderLayer(nn.Module):
    def __init__(self, config: LlamaConfig, device=None, dtype=None):
        super().__init__()
        eps = config.rms_norm_eps
        self.input_layernorm = RMSNorm(config.hidden_size, eps, device, dtype)
        self.self_attn = LlamaAttention(config, device, dtype)
        self.post_attention_layernorm = RMSNorm(config.hidden_size, eps,
                                                device, dtype)
        self.mlp = LlamaMLP(config, device, dtype)

    def forward_ref(self, x):
        x = x + self.self_attn.forward_ref(self.input_layernorm(x))
        return x + self.mlp(self.post_attention_layernorm(x))


class LlamaModel(nn.Module):
    def __init__(self, config: LlamaConfig, device=None, dtype=None):
        super().__init__()
        self.config = config
        self.embed_tokens = nn.Embedding(config.vocab_size, config.hidden_size,
                                         device=device, dtype=dtype)
        self.layers = nn.ModuleList(
            [LlamaDecoderLayer(config, device, dtype)
             for _ in range(config.num_hidden_layers)])
        self.norm = RMSNorm(config.hidden_size, config.rms_norm_eps, device,
                            dtype)

    def forward_ref(self, input_ids):
        x = self.embed_tokens(input_ids)
        for layer in self.layers:
            x = layer.forward_ref(x)
        return self.norm(x)


class LlamaForCausalLM(nn.Module):
    """Llama causal LM.  ``device`` defaults to the card (raises without
    CUDA unless ``device="cpu"``); with a ``generator`` the weights are
    drawn from it as N(0, initializer_range) (norm weights 1), in parameter
    order, on the model's device."""

    def __init__(self, config: LlamaConfig, device="cuda", dtype=None,
                 generator=None):
        super().__init__()
        if config.num_experts > 0:
            raise NotImplementedError(
                "the MoE Llama variant is not ported yet")
        dev = resolve_device(device)
        self.config = config
        self.llama = LlamaModel(config, dev, dtype)
        self.lm_head = (None if config.tie_word_embeddings else
                        _linear(config.hidden_size, config.vocab_size, dev,
                                dtype))
        if generator is not None:
            self.init_weights(generator)

    @torch.no_grad()
    def init_weights(self, generator):
        std = self.config.initializer_range
        for name, p in self.named_parameters():
            if name.endswith("norm.weight"):
                p.fill_(1.0)
            else:
                p.normal_(0.0, std, generator=generator)

    def head_weight(self):
        """The output projection [vocab, hidden] (the embedding when tied)."""
        return (self.lm_head.weight if self.lm_head is not None
                else self.llama.embed_tokens.weight)

    @torch.no_grad()
    def forward_ref(self, input_ids):
        """Plain dense forward: logits [B, S, vocab] in float32 (the head
        runs in float32, as the serving engine's does)."""
        h = self.llama.forward_ref(input_ids)
        return F.linear(h.float(), self.head_weight().float())

    def forward(self, input_ids):
        """On a CPU tensor, :meth:`forward_ref`; on the card, the model's
        forward needs the flash-attention forward kernel (K1) and raises."""
        if input_ids.device.type != "cpu":
            raise NotImplementedError(
                f"LlamaForCausalLM.forward on {input_ids.device} needs the "
                "flash-attention forward kernel (K1), which is not ported "
                "yet; use forward_ref or the serving engine")
        return self.forward_ref(input_ids)
