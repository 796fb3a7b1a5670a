"""Ulysses (DeepSpeed-style) all-to-all sequence parallelism: counterpart
of ``paddle_tpu/parallel/ulysses.py`` (SURVEY §5 long-context mechanism 2:
the reference wires the 'sep' mesh axis through topology and leaves the
attention-level CP algorithms — ring attention AND Ulysses all-to-all — to
PaddleNLP; both are in-core here).

Each rank of the 'sep' axis holds a block of the sequence:
  all_to_all(seq-shard -> head-shard) -> full-sequence attention on the
  local head group -> all_to_all back.
Between the two all-to-alls every rank sees the FULL sequence for H/sep
heads (and Hk/sep grouped K / V heads where they divide), so the attention
itself needs no communication: it is the port's flash path (K1-K3 on the
card, their plain twins on the CPU), as ``_local_heads`` runs it for heads
split over 'mp'.  ``_blockwise_sdpa`` is the reference's own blockwise body
in torch, the plain twin (and the path for shapes the kernels do not take).
With no 'sep' group of two or more ranks, attention takes the flash path
too, where the reference falls back to its plain attention.
"""
from __future__ import annotations

import math

import torch

from ..core.dispatch import apply_op
from ..ops.flash_attention import flash_attention_bshd, supported
from .ring_attention import _on_seq_shards, _sep_group

__all__ = ["ulysses_attention"]


def _a2a_raw(x, g, split_axis, concat_axis):
    import torch.distributed as dist
    n = g.nranks
    parts = torch.stack(x.chunk(n, dim=split_axis)).contiguous()
    out = torch.empty_like(parts)
    dist.all_to_all_single(out, parts, group=g.pg)
    return torch.cat(out.unbind(0), dim=concat_axis)


class _A2A(torch.autograd.Function):
    """The tiled all_to_all of ``jax.lax.all_to_all``: chunk i of
    ``split_axis`` goes to rank i, the received chunks concatenate on
    ``concat_axis`` in rank order (one ``all_to_all_single``, which gloo
    and the ``staged`` backend both take); the backward is the inverse
    exchange."""

    @staticmethod
    def forward(ctx, x, g, split_axis, concat_axis):
        ctx.g, ctx.axes = g, (split_axis, concat_axis)
        return _a2a_raw(x, g, split_axis, concat_axis)

    @staticmethod
    def backward(ctx, gout):
        s, c = ctx.axes
        return _a2a_raw(gout, ctx.g, c, s), None, None, None


def _a2a(x, g, split_axis, concat_axis):
    return _A2A.apply(x, g, split_axis, concat_axis)


def _ulysses_local(q, k, v, g, causal, scale):
    """Per-shard body. q/k/v local: [B, S/n, H, D] -> out [B, S/n, H, D]."""
    n = g.nranks
    if k.shape[2] % n:
        # grouped K / V heads that do not split over the axis: each rank
        # takes the heads its query group reads
        k = k.repeat_interleave(q.shape[2] // k.shape[2], dim=2)
        v = v.repeat_interleave(q.shape[2] // v.shape[2], dim=2)

    def seq_to_heads(x):
        # [B, s, H, D] -> [B, s*n, H/n, D]: the head axis splits into n
        # chunks (chunk i -> rank i), the received seq chunks concatenate in
        # rank order — global sequence order, rank-major heads
        return _a2a(x, g, split_axis=2, concat_axis=1)

    def heads_to_seq(x):
        # [B, S, H/n, D] -> [B, S/n, H, D]: exact inverse
        return _a2a(x, g, split_axis=1, concat_axis=2)

    qg, kg, vg = seq_to_heads(q), seq_to_heads(k), seq_to_heads(v)
    if supported(qg.shape, kg.shape):
        out = flash_attention_bshd(qg, kg, vg, causal=causal, scale=scale)
    else:
        out = _blockwise_sdpa(qg, kg, vg, causal=causal, scale=scale)
    return heads_to_seq(out.to(q.dtype))


def _blockwise_sdpa(q, k, v, causal, scale, block=1024):
    """[B, S, H, D] flash-style attention, blockwise over K with an online
    softmax (f32 statistics); grouped K / V repeated to the query heads."""
    B, S, H, D = q.shape
    if k.shape[2] != H:
        k = k.repeat_interleave(H // k.shape[2], dim=2)
        v = v.repeat_interleave(H // v.shape[2], dim=2)
    blk = min(block, S)
    while S % blk:          # a divisor of S
        blk //= 2
    nk = S // blk
    q_pos = torch.arange(S, device=q.device)
    m = torch.full((B, H, S), float("-inf"), device=q.device)
    l = torch.zeros((B, H, S), device=q.device)
    acc = torch.zeros((B, H, S, D), device=q.device)
    for j in range(nk):
        kc, vc = k[:, j * blk:(j + 1) * blk], v[:, j * blk:(j + 1) * blk]
        logits = torch.einsum("bqhd,bkhd->bhqk", q.float(),
                              kc.float()) * scale
        if causal:
            k_pos = j * blk + torch.arange(blk, device=q.device)
            mask = q_pos[:, None] >= k_pos[None, :]
            logits = torch.where(mask[None, None], logits, -1e30)
        m_new = torch.maximum(m, logits.amax(-1))
        p = torch.exp(logits - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bhqk,bkhd->bhqd", p.to(vc.dtype).float(), vc.float())
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.permute(0, 2, 1, 3)    # [B, H, S, D] -> [B, S, H, D]


def ulysses_attention(q, k, v, causal=True, axis_name="sep", mesh=None):
    """[B, S, H, D] with S sharded over `axis_name`; H must be divisible by
    the axis size. Returns the same sharding."""
    g = _sep_group(axis_name)
    if g is None:
        from ..nn.functional.attention import _flash
        return apply_op("ulysses_attention", lambda a, b, c: _flash(
            a, b, c, 0.0, causal, False, None), q, k, v)
    n = g.nranks
    if q.shape[2] % n != 0:
        raise ValueError(
            f"ulysses needs heads ({q.shape[2]}) divisible by the "
            f"'{axis_name}' axis size ({n})")
    scale = 1.0 / math.sqrt(q.shape[-1])

    def f(qa, ka, va):
        return _on_seq_shards(
            lambda a, b, c: _ulysses_local(a, b, c, g, bool(causal), scale),
            qa, ka, va, axis_name)

    return apply_op("ulysses_attention", f, q, k, v)
