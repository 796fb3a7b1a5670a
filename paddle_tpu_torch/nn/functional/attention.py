"""Attention functionals: counterpart of
``paddle_tpu/nn/functional/attention.py``.

Both functionals take ``[B, S, H, D]`` tensors: port ``Tensor``s, which go
through ``apply_op`` as the reference's do (one dispatch; the flash
wrapper's own ``torch.autograd.Function`` is the tape node, with no second
wrapper around it), or ``torch.Tensor``s, which the ``torch.nn`` models
(``models/gpt2_module.py``, ``models/llama_module.py``) pass.  Dispatch follows the
reference: with no mask, no dropout in training and a shape the kernels
take (:func:`~paddle_tpu_torch.ops.flash_attention.supported`), attention
goes through :func:`~paddle_tpu_torch.ops.flash_attention.flash_attention_bshd`
— the flash kernels K1-K3 on the card, their plain twins on the CPU (the
wrapper, not this module, looks at the device) — and otherwise through
:func:`_sdpa_ref`, the reference's own dense path, which is not a kernel's
twin.  Dropout draws from a ``torch.Generator`` (the given one; else, for
``Tensor`` inputs, the global generator's on their device, as the
reference draws a key from its own; for torch inputs torch's default), so
its random bits cannot match JAX's.
"""
from __future__ import annotations

import math

import torch

from ...core import sharding
from ...core.dispatch import apply_op, unwrap
from ...core.tensor import Tensor
from ...ops.flash_attention import flash_attention_bshd, supported

__all__ = ["scaled_dot_product_attention", "flash_attention",
           "flash_attn_unpadded", "sequence_mask", "paged_attention",
           "_sdpa_ref"]


def _sdpa_ref(q, k, v, mask=None, causal=False, dropout_p=0.0, scale=None,
              generator=None):
    """Dense attention over [B, S, H, D] in float32: grouped-query heads
    folded into the einsum (K / V never repeated), causal mask aligned to
    the bottom right (tril offset Sk - Sq) and boolean masks as -inf,
    additive masks added, softmax, optional dropout; output in q's
    dtype."""
    d = q.shape[-1]
    s = scale if scale is not None else 1.0 / math.sqrt(d)
    B, sq, hq, _ = q.shape
    sk, hk = k.shape[1], k.shape[2]
    rep = hq // hk
    qg = q.float().reshape(B, sq, hk, rep, d)
    logits = torch.einsum("bskrd,btkd->bkrst", qg, k.float()) * s
    if causal:
        cm = torch.ones(sq, sk, dtype=torch.bool, device=q.device).tril(
            sk - sq)
        logits = logits.masked_fill(~cm, float("-inf"))
    if mask is not None:
        m5 = mask.broadcast_to(B, hq, sq, sk).reshape(B, hk, rep, sq, sk)
        if mask.dtype == torch.bool:
            logits = logits.masked_fill(~m5, float("-inf"))
        else:
            logits = logits + m5.float()
    p = torch.softmax(logits, dim=-1)
    if dropout_p > 0.0:
        keep = torch.rand(p.shape, generator=generator, device=p.device) \
            >= dropout_p
        p = torch.where(keep, p / (1.0 - dropout_p), 0.0)
    out = torch.einsum("bkrst,btkd->bskrd", p, v.float())
    return out.reshape(B, sq, hq, d).to(q.dtype)


def _sep_sharded(q):
    """Whether sharded q [B, S, H, D] has its sequence split over 'sep'."""
    names = q.device_mesh.mesh_dim_names or ()
    return any(p.is_shard() and p.dim % 4 == 1 and names[i] == "sep"
               for i, p in enumerate(q.placements))


def _ring(q, k, v, causal):
    """Causal or full attention of a sequence split over 'sep': the ring
    (``parallel/ring_attention.py``, the flash kernels a block)."""
    from ...distributed.fleet.topology import get_hybrid_communicate_group
    from ...parallel.ring_attention import ring_on_shards
    g = get_hybrid_communicate_group().axis_group("sep")
    return ring_on_shards(q, k, v, causal, g)


def _local_heads(fn, q, k, v):
    """``fn`` on each rank's shard of sharded [B, S, H, D] inputs: batch and
    heads may be split (k and v take q's placements; GQA keeps its ratio
    per rank), so the flash kernels run on local heads; a sequence split
    over 'sep' goes to the ring (``_sdpa`` / ``_flash``), over any other
    axis, or a split head_dim, raises."""
    dm, pl = q.device_mesh, q.placements
    for p in pl:
        if p.is_shard() and p.dim % 4 in (1, 3):
            raise NotImplementedError(
                "attention over a sequence split on an axis other than "
                "'sep', or over a split head_dim")
    k, v = [(t if sharding.is_sharded(t) else sharding.replicated(t, dm))
            .redistribute(dm, pl) for t in (k, v)]
    out = fn(*(_ContiguousGrad.apply(t.to_local()) for t in (q, k, v)))
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(out, dm, pl, run_check=False)


class _ContiguousGrad(torch.autograd.Function):
    """The identity, whose gradient leaves contiguous: a shard's gradient
    re-enters DTensor, whose views of it assume a contiguous layout (the
    kernels' dK / dV of one local head need not be)."""

    @staticmethod
    def forward(ctx, t):
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def _sdpa(query, key, value, attn_mask, dropout_p, is_causal, training,
          generator):
    if sharding.is_sharded(query):
        if attn_mask is not None:
            raise NotImplementedError("masked attention of sharded inputs")
        if _sep_sharded(query) and not (training and dropout_p):
            return _ring(query, key, value, is_causal)
        return _local_heads(lambda q, k, v: _sdpa(
            q, k, v, None, dropout_p, is_causal, training, generator),
            query, key, value)
    drop = dropout_p if training else 0.0
    if attn_mask is None and drop == 0.0 and supported(query.shape,
                                                        key.shape):
        return flash_attention_bshd(query, key, value, causal=is_causal)
    return _sdpa_ref(query, key, value, mask=attn_mask, causal=is_causal,
                     dropout_p=drop, generator=generator)


def _flash(query, key, value, dropout, causal, training, generator):
    if sharding.is_sharded(query):
        if _sep_sharded(query) and not (training and dropout):
            return _ring(query, key, value, causal)
        return _local_heads(lambda q, k, v: _flash(
            q, k, v, dropout, causal, training, generator), query, key, value)
    drop = dropout if training else 0.0
    if drop == 0.0 and supported(query.shape, key.shape):
        return flash_attention_bshd(query, key, value, causal=causal)
    return _sdpa_ref(query, key, value, causal=causal, dropout_p=drop,
                     generator=generator)


def _generator(query, drop, generator):
    """The dropout generator of a Tensor-level call: the given one, else
    the global generator's on the query's device."""
    if generator is not None or drop == 0.0:
        return generator
    from ...core.rng import next_generator
    return next_generator(query._buf.device)


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True, name=None, generator=None):
    """paddle.nn.functional.scaled_dot_product_attention ([B, S, H, D])."""
    if not isinstance(query, Tensor):
        return _sdpa(query, key, value, attn_mask, dropout_p, is_causal,
                     training, generator)
    m = unwrap(attn_mask)
    gen = _generator(query, dropout_p if training else 0.0, generator)
    return apply_op("scaled_dot_product_attention",
                    lambda q, k, v: _sdpa(q, k, v, m, dropout_p, is_causal,
                                          training, gen),
                    query, key, value)


def flash_attention(query, key, value, dropout=0.0, causal=False,
                    return_softmax=False, fixed_seed_offset=None, rng_name="",
                    training=True, name=None, generator=None):
    """Flash attention ([B, S, H, D]); returns ``(out, None)``, as the
    reference does (the softmax is never returned)."""
    if not isinstance(query, Tensor):
        return _flash(query, key, value, dropout, causal, training,
                      generator), None
    gen = _generator(query, dropout if training else 0.0, generator)
    out = apply_op("flash_attention",
                   lambda q, k, v: _flash(q, k, v, dropout, causal, training,
                                          gen),
                   query, key, value)
    return out, None


def flash_attn_unpadded(*args, **kwargs):
    raise NotImplementedError(
        "varlen flash attention: use dense [B,S,H,D] flash_attention with masking; "
        "ragged support lands with the paged-attention kernel")


def sequence_mask(x, maxlen=None, dtype="int64", name=None):
    """[..., maxlen] mask of the positions below each length (``maxlen``
    defaults to the largest length)."""
    from ...core.dtype import convert_dtype
    from ...core.tensor import _wrap
    lengths = unwrap(x)
    ml = int(maxlen) if maxlen is not None else int(lengths.max())
    row = torch.arange(ml, device=lengths.device)
    mask = row < lengths[..., None]
    return _wrap(mask.to(convert_dtype(dtype)))


def paged_attention(query, key_pages, value_pages, block_tables, context_lens,
                    scale=None, name=None):
    """Decode attention against a paged KV cache (reference:
    phi/kernels/fusion block_multi_head_attention): the Tensor-level wrapper
    of :func:`~paddle_tpu_torch.ops.paged_attention.paged_attention` (K5 on
    the card, its plain version on the CPU)."""
    from ...ops.paged_attention import paged_attention as _kern
    bt, cl = unwrap(block_tables), unwrap(context_lens)
    return apply_op("paged_attention",
                    lambda q, kp, vp: _kern(q, kp, vp, bt, cl, scale=scale),
                    query, key_pages, value_pages)
