"""Llama-3 family in PyTorch: the counterpart of ``paddle_tpu/models/llama.py``.

``LlamaForCausalLM`` is an ``nn.Module`` whose parameter names equal the JAX
model's ``state_dict()`` keys (``llama.embed_tokens.weight``,
``llama.layers.{i}.self_attn.q_proj.weight``, ..., ``lm_head.weight``), so
weights cross between the packages by name (see :mod:`.convert`).  Linear
weights are stored the torch way, ``[out, in]``.

The serving engine reads the weights directly.  ``forward`` (the training
path, with ``labels`` for the loss) attends through
:func:`~paddle_tpu_torch.nn.functional.flash_attention`, so on the card it
launches the flash kernels K1 (forward) and K2 + K3 (backward) with GQA;
:meth:`LlamaForCausalLM.forward_ref` is the plain dense reference it is
checked against.  MoE and the pipeline stage classes are not ported.
Autoregressive decoding with a dense per-layer :class:`KVCache`
(:meth:`LlamaForCausalLM.generate`, what the speculative decoder's draft
model runs) attends through :func:`_cached_sdpa`, plain tensor code on any
device, as the JAX package's ``_cached_sdpa`` is plain jnp outside any
Pallas kernel.  As the reference keeps ``_gen_states``, ``generate`` keeps
its caches and its decode step on the model, keyed by (batch, cache
bucket, sampling config, K); the step is a captured program (a CUDA graph
on the card) that greedy decoding replays.
"""
from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device
from ..jit.capture import CapturedProgram, graph_pool
from ..nn.functional import cross_entropy, flash_attention
from ..nn.functional.attention import _sdpa_ref
from ..ops.paged_attention import quantize_kv

__all__ = ["LlamaConfig", "LlamaForCausalLM", "KVCache", "rope", "rms_norm",
           "causal_lm_loss"]


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


class KVCache:
    """Per-layer dense KV cache [batch, max_len, KVH, D] for autoregressive
    decode, with the write offset (the serving path's paged variant lives in
    the engine's runner).  Counterpart of the JAX ``KVCache``: the offset
    lives on the device (``pos``, a 0-d int32 tensor, as the reference's
    offset is program state), so a decode step that reads and advances it
    can be captured and replayed; ``offset`` is its host mirror, for the
    overflow check.  The cache is written in place."""

    def __init__(self, batch, max_len, num_kv_heads, head_dim,
                 dtype=torch.float32, device="cuda"):
        dev = resolve_device(device)
        self.k = torch.zeros((batch, max_len, num_kv_heads, head_dim),
                             dtype=dtype, device=dev)
        self.v = torch.zeros_like(self.k)
        self.pos = torch.zeros((), dtype=torch.int32, device=dev)
        self.offset = 0
        self.max_len = max_len

    def reset(self):
        """Rewind to position 0; what the tail holds is masked, never
        read."""
        self.pos.fill_(0)
        self.offset = 0

    def update(self, k_new, v_new):
        """Write the s new steps [batch, s, KVH, D] at the offset; returns
        the FULL cache — consumers mask the unwritten tail instead of
        slicing it."""
        s = k_new.shape[1]
        if self.offset + s > self.max_len:
            raise ValueError(f"KVCache of {self.max_len} positions is full "
                             f"(offset {self.offset}, {s} new)")
        idx = (self.pos + torch.arange(s, device=self.pos.device)).long()
        self.k.index_copy_(1, idx, k_new.to(self.k.dtype))
        self.v.index_copy_(1, idx, v_new.to(self.v.dtype))
        self.pos += s
        self.offset += s
        return self.k, self.v


def _cached_sdpa(q, k, v, q_offset):
    """Attention of the s query positions starting at ``q_offset`` (an int
    or a 0-d device tensor; q [b, s, h, d]) against the FULL fixed-length cache k / v [b, t, kvh, d]:
    float32 scores, -1e30 above each row's causal horizon (which also hides
    the not-yet-written tail), float32 softmax, output in q's dtype."""
    b, s, h, d = q.shape
    t = k.shape[1]
    rep = h // k.shape[2]
    if rep > 1:        # each kv head rep times in a row, by shape alone
        k = k[:, :, :, None].expand(-1, -1, -1, rep, -1).reshape(b, t, h, d)
        v = v[:, :, :, None].expand(-1, -1, -1, rep, -1).reshape(b, t, h, d)
    sc = torch.einsum("bshd,bthd->bhst", q.float(), k.float()) / math.sqrt(d)
    rows = q_offset + torch.arange(s, device=q.device)[:, None]
    cols = torch.arange(t, device=q.device)[None, :]
    sc = torch.where(cols <= rows, sc, -1e30)
    p = torch.softmax(sc, dim=-1)
    out = torch.einsum("bhst,bthd->bshd", p, v.float())
    return out.to(q.dtype)


def _int8_round_trip(x):
    """K or V rows through the int8 KV cache's quantization and back, in
    float32 (what the engine's int8 pages hold, dequantized as its plain
    attention does)."""
    xq, s = quantize_kv(x)
    return xq.float() * s[..., None]


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

    def _qkv(self, x, position_ids):
        b, s, _ = x.shape
        nh, kvh, d = self.num_heads, self.num_kv_heads, self.head_dim
        q = self.q_proj(x).view(b, s, nh, d)
        k = self.k_proj(x).view(b, s, kvh, d)
        v = self.v_proj(x).view(b, s, kvh, d)
        q = rope(q, position_ids, self.rope_theta)
        return q, rope(k, position_ids, self.rope_theta), v

    def forward_ref(self, x, kv_int8=False):
        """Dense causal GQA attention over x [B, S, hidden], float32
        softmax.  ``kv_int8``: K and V pass through the int8 KV cache's
        quantization first (the reference an int8-page engine is held
        against)."""
        b, s, _ = x.shape
        q, k, v = self._qkv(x, torch.arange(s, device=x.device))
        if kv_int8:
            k, v = _int8_round_trip(k), _int8_round_trip(v)
        out = _sdpa_ref(q, k, v, causal=True)
        return self.o_proj(out.reshape(b, s, -1))

    def forward(self, x, position_ids=None, kv_cache=None):
        """With ``kv_cache``: the s new positions (at the cache's offset
        unless ``position_ids`` says otherwise) write their K/V into it and
        attend through :func:`_cached_sdpa`.  Without: causal GQA attention
        through ``flash_attention`` (K1 forward, K2 + K3 backward on the
        card, where the shape allows; the reference's dense path
        otherwise)."""
        b, s, _ = x.shape
        if position_ids is None:
            off = kv_cache.pos if kv_cache is not None else 0
            position_ids = (torch.arange(s, device=x.device)
                            + off)[None].expand(b, s)
        q, k, v = self._qkv(x, position_ids)
        if kv_cache is not None:
            q_offset = kv_cache.pos.clone()  # before the in-place update
            kk, vv = kv_cache.update(k, v)
            out = _cached_sdpa(q, kk, vv, q_offset)
        else:
            out, _ = flash_attention(q, k, v, causal=True)
        return self.o_proj(out.reshape(b, s, -1))


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

    def forward_ref(self, x, kv_int8=False):
        x = x + self.self_attn.forward_ref(self.input_layernorm(x), kv_int8)
        return x + self.mlp(self.post_attention_layernorm(x))

    def forward(self, x, position_ids=None, kv_cache=None):
        x = x + self.self_attn(self.input_layernorm(x), position_ids,
                               kv_cache=kv_cache)
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

    def forward_ref(self, input_ids, kv_int8=False):
        x = self.embed_tokens(input_ids)
        for layer in self.layers:
            x = layer.forward_ref(x, kv_int8)
        return self.norm(x)

    def forward(self, input_ids, position_ids=None, kv_caches=None):
        x = self.embed_tokens(input_ids)
        for i, layer in enumerate(self.layers):
            x = layer(x, position_ids,
                      kv_cache=kv_caches[i] if kv_caches else None)
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
        self._gen_states = {}        # generate()'s caches and programs
        self._gen_pool = None        # their graphs' memory pool

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

    @property
    def device(self):
        return self.llama.embed_tokens.weight.device

    @torch.no_grad()
    def forward_ref(self, input_ids, kv_int8=False):
        """Plain dense forward: logits [B, S, vocab] in float32 (the head
        runs in float32, as the serving engine's does).  ``kv_int8``: every
        layer's K and V pass through the int8 KV cache's quantization and
        back first — the reference an engine with int8 pages is held
        against."""
        h = self.llama.forward_ref(input_ids, kv_int8)
        return F.linear(h.float(), self.head_weight().float())

    def forward(self, input_ids, labels=None, position_ids=None):
        """Logits [B, S, vocab] in the model's dtype through the flash
        attention path; with ``labels`` (the target of each position as
        given, -100 ignored) ``(logits, loss)`` with the loss of
        :func:`causal_lm_loss`."""
        hidden = self.llama(input_ids, position_ids)
        logits = F.linear(hidden, self.head_weight())
        if labels is not None:
            return logits, causal_lm_loss(logits, labels,
                                          self.config.vocab_size)
        return logits

    def new_kv_caches(self, batch, max_len, dtype=torch.float32):
        cfg = self.config
        return [KVCache(batch, max_len, cfg.num_key_value_heads,
                        cfg.hidden_size // cfg.num_attention_heads, dtype,
                        self.device)
                for _ in range(cfg.num_hidden_layers)]

    def _head(self, hidden):
        """Logits in the model's dtype, as the reference's generate takes
        them (the serving engine's head runs in float32)."""
        return F.linear(hidden, self.head_weight())

    @torch.no_grad()
    def generate(self, input_ids, max_new_tokens=32, do_sample=False,
                 top_p=1.0, top_k=0, temperature=1.0, eos_token_id=None,
                 use_cache=True, seed=None, tokens_per_dispatch=None):
        """Autoregressive decoding with a per-layer dense KV cache; greedy
        when do_sample=False, nucleus / top-k sampling otherwise (a fixed
        ``seed`` keys every draw alike, so draws are reproducible within the
        port; they cannot match the JAX package's).  input_ids [B, prompt]
        int64 on the model's device; returns [B, prompt + new].

        The cache holds prompt + new tokens rounded up to a power of two
        (at least 128) positions, as the reference sizes it, and persists
        on the model with its decode step (:meth:`_gen_state`).  The prompt
        runs eagerly; the decode step is a
        :class:`~paddle_tpu_torch.jit.capture.CapturedProgram`: greedy
        steps replay its CUDA graph on the card, sampled ones (a seeded
        ``torch.Generator`` cannot be captured) run its body eagerly.
        tokens_per_dispatch: decode steps run back to back in one program
        before the host looks at the tokens (default 1); eos checking needs
        each token, so it forces 1.  ``use_cache=False`` re-runs the whole
        sequence through the model's forward every step."""
        b, prompt = input_ids.shape
        K = 1 if tokens_per_dispatch is None else tokens_per_dispatch
        K = max(1, min(int(K), max_new_tokens))
        if eos_token_id is not None:
            K = 1                          # host must see every token
        sampling = (do_sample, top_p, top_k, temperature, seed)
        entry = None
        if use_cache:
            # K>1 overshoots up to K-1 tokens past max_new before the trim
            need = prompt + -(-max_new_tokens // K) * K
            entry = self._gen_state(
                b, 1 << max(7, (need - 1).bit_length()), sampling, K)

        toks, cur, finished = [input_ids], input_ids, None
        n_dispatch = -(-max_new_tokens // K) if use_cache else max_new_tokens
        try:
            if use_cache:            # the prompt runs eagerly
                cur = self._next_token(
                    self.llama(input_ids, kv_caches=entry["caches"]),
                    sampling)
                entry["pos"] = prompt
            for i in range(n_dispatch):
                if use_cache:
                    # dispatch 0: the prompt's token and K - 1 steps
                    # (eagerly, as the reference's first dispatch is its
                    # prefill trace); later ones: the K-step program
                    step, n = entry["step"], K - 1 if i == 0 else K
                    if i == 0:
                        blk = cur if n == 0 else torch.cat([cur, (
                            step.run_eager({"cur": cur}, functools.partial(
                                self._decode_steps, entry, sampling, n)))],
                            1)
                    elif do_sample or entry["private"]:
                        blk = step.run_eager({"cur": cur})
                    else:
                        blk = step.run({"cur": cur})
                    entry["pos"] += n
                    for c in entry["caches"]:
                        c.offset = entry["pos"]
                    nxt = blk[:, -1:]
                else:
                    nxt = self._next_token(self.llama(torch.cat(toks, 1)),
                                           sampling)
                if eos_token_id is not None:
                    done_now = (nxt == eos_token_id).reshape(-1)
                    if finished is not None:
                        nxt = torch.where(finished, eos_token_id,
                                          nxt.reshape(-1)).reshape(-1, 1)
                        done_now = finished | done_now
                    finished = done_now
                nxt = nxt.to(input_ids.dtype)
                toks.append(blk.to(input_ids.dtype)
                            if use_cache and K > 1 else nxt)
                cur = nxt
                if finished is not None and bool(finished.all()):
                    break
        finally:
            if entry is not None:
                entry["busy"] = False
        out = torch.cat(toks, dim=1)
        return out[:, :prompt + max_new_tokens]     # trim the K overshoot

    def _gen_state(self, batch, max_len, sampling, K):
        """The reference's ``_gen_states`` entry for (batch, cache bucket,
        sampling config, K): the per-layer caches and the K-step decode
        program, kept on the model (at most 4 entries, the oldest dropped)
        and reused with the offset rewound.  An entry in use (``busy``: a
        reentrant or concurrent ``generate``) is not shared: the caller
        gets a private entry, not stored, whose steps run eagerly (a graph
        used once costs more than it saves, and capturing beside another
        call's launches is unsafe).  Returns the entry, marked busy."""
        key = (batch, max_len) + tuple(sampling) + (K,)
        existing = self._gen_states.get(key)
        if existing is not None and not existing["busy"]:
            entry = existing
            for c in entry["caches"]:
                c.reset()
        else:
            if self._gen_pool is None:
                self._gen_pool = graph_pool(self.device)
            entry = {"caches": self.new_kv_caches(batch, max_len),
                     "busy": False, "pos": 0,
                     "private": existing is not None}
            cur = torch.zeros((batch, 1), dtype=torch.long,
                              device=self.device)
            entry["step"] = CapturedProgram(
                functools.partial(self._decode_steps, entry, sampling, K),
                {"cur": cur}, self._gen_pool,
                f"generate/{batch}x{max_len}/K{K}")
            if existing is None:
                self._gen_states[key] = entry
                while len(self._gen_states) > 4:   # bound retained memory
                    self._gen_states.pop(next(iter(self._gen_states)))
        entry["busy"] = True
        return entry

    def _decode_steps(self, entry, sampling, n, bufs):
        """``n`` decode steps from the tokens bufs["cur"] [B, 1] through the
        entry's caches; returns the tokens [B, n].  The caches' host
        offsets restart from the entry's position: capturing runs this body
        twice for one dispatch (the warm-up, then the capture)."""
        for c in entry["caches"]:
            c.offset = entry["pos"]
        tok, outs = bufs["cur"], []
        for _ in range(n):
            tok = self._next_token(self.llama(tok, kv_caches=entry["caches"]),
                                   sampling)
            outs.append(tok)
        return torch.cat(outs, 1)

    def _next_token(self, hidden, sampling):
        """The next token [B, 1] after the last position of ``hidden``."""
        return self._sample(self._head(hidden[:, -1]), *sampling)

    def _sample(self, logits, do_sample, top_p, top_k, temperature, seed):
        """Next token [B, 1] from logits [B, vocab], in the reference's
        order: greedy argmax (first index on ties), or temperature ->
        softmax -> top-k -> top-p over the sorted vocab -> one draw, from a
        ``torch.Generator`` seeded ``seed`` when one is given."""
        if not do_sample:
            return logits.argmax(dim=-1, keepdim=True)
        if temperature and temperature != 1.0:
            logits = logits / temperature
        probs = torch.softmax(logits.float(), dim=-1)
        if top_k:
            thresh = probs.topk(top_k, dim=-1).values[:, -1:]
            probs = torch.where(probs >= thresh, probs, 0.0)
            probs = probs / probs.sum(-1, keepdim=True)
        gen = None
        if seed is not None:
            gen = torch.Generator(device=probs.device).manual_seed(int(seed))
        if top_p < 1.0:
            sp, idx = probs.sort(dim=-1, descending=True, stable=True)
            sp = torch.where(sp.cumsum(-1) - sp < top_p, sp, 0.0)
            choice = torch.multinomial(sp / sp.sum(-1, keepdim=True), 1,
                                       generator=gen)
            return idx.gather(-1, choice)
        return torch.multinomial(probs, 1, generator=gen)


def causal_lm_loss(logits, labels, vocab_size, aux_loss=None, aux_coef=0.01):
    """Token cross-entropy (+ an optional auxiliary loss): the reference's
    one loss formula for the dense and pipelined models."""
    loss = cross_entropy(logits.reshape(-1, vocab_size), labels.reshape(-1))
    if aux_loss is not None:
        loss = loss + aux_coef * aux_loss
    return loss
