"""Ring attention for sequence/context parallelism: counterpart of
``paddle_tpu/parallel/ring_attention.py`` (SURVEY §5 long-context: the
reference provides the 'sep' mesh axis + four-direction p2p
(fleet/base/topology.py:199, pp_utils/four_directions_p2p_communication.py);
ring/blockwise attention itself lives downstream in PaddleNLP).

Each rank of the 'sep' axis holds a block of the sequence; K/V blocks
rotate around the ring with ``mesh_ppermute``'s exchange.  The forward runs
the flash forward on each arriving block (K1 on the card through
``ops/flash_attention.py``'s launcher, its plain twin ``flash_fwd_ref`` on
the CPU): causal on the diagonal block, non-causal on blocks from earlier
ranks, skipped for later ones (the reference masks them; the result is the
same), and merges the block outputs by their log-sum-exps in float32 into
the global O and LSE.  The backward (one ``torch.autograd.Function``) runs
K2 and K3 on each block against the global O and LSE, K2 computing delta
from them, and the dK / dV of each block ride the ring with it back to its
owner.  Grouped-query K / V rotate as they are (the kernels take them).
With no 'sep' group of two or more ranks, attention takes the port's
flash path (K1-K3 on the card), where the reference falls back to its
plain attention.

``_ring_attn_local`` is the reference's own body in torch (f32 online
softmax over the rotating blocks, differentiable through
``mesh_ppermute``): the plain twin the kernels' path is held to.
"""
from __future__ import annotations

import math

import torch

from ..core import sharding
from ..core.dispatch import apply_op
from ..distributed.collective import mesh_ppermute, _permute
from ..distributed.fleet.topology import get_hybrid_communicate_group
from ..ops import flash_attention as fa


def _ring_attn_local(q, k, v, axis_name, causal, scale):
    """Per-shard body: q local [B, Sq, H, D]; k/v rotate around the ring.

    Online softmax: keep running (max, sum, acc) in f32 while blocks arrive.
    Causality across blocks is decided by comparing global block offsets.
    """
    g = get_hybrid_communicate_group().axis_group(axis_name)
    n = g.nranks
    my_idx = g.get_rank()
    B, Sq, H, D = q.shape
    if k.shape[2] != H:
        k = k.repeat_interleave(H // k.shape[2], dim=2)
        v = v.repeat_interleave(H // v.shape[2], dim=2)

    def attend(carry, kb, vb, src_idx):
        m_prev, l_prev, acc = carry
        logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), kb.float()) * scale
        if causal:
            q_pos = my_idx * Sq + torch.arange(Sq, device=q.device)
            k_pos = src_idx * kb.shape[1] + torch.arange(kb.shape[1],
                                                         device=q.device)
            mask = q_pos[:, None] >= k_pos[None, :]
            logits = logits.masked_fill(~mask, float("-inf"))
        m_cur = logits.amax(-1)
        m_new = torch.maximum(m_prev, m_cur)
        # guard fully-masked rows
        m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
        p = torch.exp(logits - m_safe[..., None])
        p = torch.where(torch.isfinite(logits), p, 0.0)
        corr = torch.exp(torch.where(torch.isfinite(m_prev), m_prev - m_safe,
                                     float("-inf")))
        corr = torch.where(torch.isfinite(corr), corr, 0.0)
        l_new = l_prev * corr + p.sum(-1)
        acc_new = acc * corr[..., None] + torch.einsum(
            "bhqk,bkhd->bhqd", p.to(vb.dtype).float(), vb.float())
        return (m_new, l_new, acc_new)

    carry = (torch.full((B, H, Sq), float("-inf"), device=q.device),
             torch.zeros((B, H, Sq), device=q.device),
             torch.zeros((B, H, Sq, D), device=q.device))
    kb, vb = k, v
    src = my_idx
    perm = [(i, (i + 1) % n) for i in range(n)]
    for step in range(n):
        carry = attend(carry, kb, vb, src)
        if step < n - 1:
            kb = mesh_ppermute(kb, axis_name, perm)
            vb = mesh_ppermute(vb, axis_name, perm)
            src = (src - 1) % n
    m, l, acc = carry
    out = acc / torch.clamp(l, min=1e-20)[..., None]
    return out.permute(0, 2, 1, 3).to(q.dtype)


def _block_fwd(q, k, v, causal, s):
    """K1 on one block (its plain twin on the CPU): (o, lse [B * H, Sq])."""
    if fa._device_path(q, "ring_flash_attention") == "cpu":
        return fa.flash_fwd_ref(q, k, v, causal, s)
    fa._check_divisible(q.shape[1], k.shape[1], q.shape[3])
    fa._check(q, k, v)
    return fa._launch_fwd(fa._strided(q), fa._strided(k), fa._strided(v),
                          causal, s)


def _block_bwd(q, k, v, o, lse, do, causal, s):
    """K2 then K3 on one block against the global o and lse (their plain
    twin on the CPU): (dq, dk, dv)."""
    if fa._device_path(q, "ring_flash_attention") == "cpu":
        return fa.flash_bwd_ref(q, k, v, o, lse, do, causal, s)
    q, k, v = fa._strided(q), fa._strided(k), fa._strided(v)
    dq, delta = fa._launch_dq(q, k, v, o, lse, do, causal, s)
    dk, dv = fa._launch_dkv(q, k, v, o, lse, do, delta, causal, s)
    return dq, dk, dv


class _Ring(torch.autograd.Function):
    """The ring over group ``g`` on local blocks q [B, s, H, D], k / v
    [B, s, Hk, D]: flash kernels a block, LSE merge in f32; the backward
    rotates K / V again with their dK / dV accumulators."""

    @staticmethod
    def forward(ctx, q, k, v, g, causal, scale):
        n, r = g.nranks, g.get_rank()
        B, s, H, _ = q.shape
        perm = tuple((i, (i + 1) % n) for i in range(n))
        o_acc = lse_acc = None
        kb, vb = k.detach(), v.detach()
        q = q.detach()
        for t in range(n):
            src = (r - t) % n
            if not causal or src <= r:
                o_b, lse_b = _block_fwd(q, kb, vb, causal and src == r, scale)
                if o_acc is None:
                    o_acc, lse_acc = o_b.float(), lse_b
                else:
                    lse = torch.logaddexp(lse_acc, lse_b)

                    def w(x):
                        return torch.exp(x - lse).reshape(B, H, s).permute(
                            0, 2, 1)[..., None]
                    o_acc = o_acc * w(lse_acc) + o_b.float() * w(lse_b)
                    lse_acc = lse
            if t < n - 1:
                kb, vb = _permute(kb, g, perm), _permute(vb, g, perm)
        o = o_acc.to(q.dtype)
        ctx.save_for_backward(q, k.detach(), v.detach(), o, lse_acc)
        ctx.g, ctx.causal, ctx.scale = g, causal, scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        g, causal, scale = ctx.g, ctx.causal, ctx.scale
        n, r = g.nranks, g.get_rank()
        perm = tuple((i, (i + 1) % n) for i in range(n))
        do = sharding.full(do).contiguous()
        if do.device.type == "cuda":
            do = fa._strided(do)
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        kb, vb = k, v
        dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
        dv = torch.zeros_like(dk)
        for t in range(n):
            src = (r - t) % n
            if not causal or src <= r:
                dq_b, dk_b, dv_b = _block_bwd(q, kb, vb, o, lse, do,
                                              causal and src == r, scale)
                dq += dq_b.float()
                dk += dk_b.float()
                dv += dv_b.float()
            if t < n - 1:
                kb, vb = _permute(kb, g, perm), _permute(vb, g, perm)
            # each accumulator travels with its block; after the last step
            # one more hop hands it to the block's owner
            dk, dv = _permute(dk, g, perm), _permute(dv, g, perm)
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None,
                None)


def _on_seq_shards(fn, q, k, v, axis_name):
    """``fn(q, k, v)`` on this rank's shards of [B, S, H, D] tensors with the
    sequence split over ``axis_name`` (a tensor replicated there is split
    here); the output keeps q's other placements with the sequence split.
    Plain tensors (the same on every rank) are split here and the output
    gathered, so every rank returns the whole value, as the reference's
    ``shard_map`` does."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from ..nn.functional.attention import _ContiguousGrad
    plain = not sharding.is_sharded(q)
    if plain:
        dm = get_hybrid_communicate_group().get_mesh().device_mesh(
            q.device.type)
    else:
        dm = q.device_mesh
    d = dm.mesh_dim_names.index(axis_name)
    pl = [Replicate()] * dm.ndim if plain else list(q.placements)
    pl[d] = Shard(1)
    local = []
    for t in (q, k, v):
        t = t if sharding.is_sharded(t) else sharding.replicated(t, dm)
        local.append(_ContiguousGrad.apply(t.redistribute(dm, pl).to_local()))
    out = DTensor.from_local(fn(*local), dm, pl, run_check=False)
    if plain:
        out = out.redistribute(dm, [Replicate()] * dm.ndim).to_local()
    return out


def _sep_group(axis_name):
    hcg = get_hybrid_communicate_group()
    if axis_name not in hcg.get_mesh().dim_names:
        return None
    g = hcg.axis_group(axis_name)
    return g if g.pg is not None and g.nranks > 1 else None


def ring_flash_attention(q, k, v, causal=True, axis_name="sep", mesh=None):
    """[B, S, H, D] with S sharded over `axis_name`; returns same sharding."""
    g = _sep_group(axis_name)
    if g is None:
        from ..nn.functional.attention import _flash
        return apply_op("ring_attention", lambda a, b, c: _flash(
            a, b, c, 0.0, causal, False, None), q, k, v)
    return apply_op("ring_attention",
                    lambda a, b, c: ring_on_shards(a, b, c, causal, g,
                                                   axis_name), q, k, v)


def ring_on_shards(q, k, v, causal, g, axis_name="sep"):
    """The ring over group ``g`` on torch buffers (DTensors with the
    sequence split over ``axis_name``, or tensors the same on every
    rank)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    return _on_seq_shards(
        lambda a, b, c: _Ring.apply(a, b, c, g, bool(causal), scale),
        q, k, v, axis_name)
