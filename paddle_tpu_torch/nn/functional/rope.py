"""Rotary position embedding: counterpart of
``paddle_tpu/nn/functional/rope.py`` — a first-class op in the reference
(phi/ops/yaml fused_rope; spmd rule phi/infermeta/spmd_rules/fused_rope.cc).

The same tables and rotations in torch, computed in float32 and returned
in each input's dtype.  Where ``position_ids`` is given without
``max_position`` the table reaches the largest position (one host read);
inside a CUDA graph being captured it covers the sequence, as the
reference falls back for traced positions.
"""
from __future__ import annotations

import torch

from ...core.dispatch import apply_op, unwrap


def _rotate_half(x):
    x1, x2 = torch.chunk(x, 2, dim=-1)
    return torch.cat([-x2, x1], dim=-1)


def _sin_cos(seq_len, head_dim, base, device):
    inv = 1.0 / (base ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                       device=device) / head_dim))
    t = torch.arange(seq_len, dtype=torch.float32, device=device)
    freqs = torch.outer(t, inv)
    emb = torch.cat([freqs, freqs], dim=-1)
    return torch.sin(emb), torch.cos(emb)


def fused_rotary_position_embedding(q, k=None, v=None, sin=None, cos=None,
                                    position_ids=None, use_neox_rotary_style=True,
                                    time_major=False, rotary_emb_base=10000.0,
                                    max_position=None):
    """Apply RoPE to q/k/v ([B, S, H, D]). Returns (q', k', v') like the
    reference. `max_position` bounds the sin/cos table statically (a
    captured decode step, whose positions are device data)."""
    sin_a, cos_a = unwrap(sin), unwrap(cos)
    pos = unwrap(position_ids) if position_ids is not None else None

    def build(a, seq_len, head_dim):
        if sin_a is not None:
            s, c = sin_a, cos_a
        else:
            if pos is not None:
                if max_position is not None:
                    seq_len = max(seq_len, int(max_position))
                elif not (pos.is_cuda
                          and torch.cuda.is_current_stream_capturing()):
                    # decode: the table must reach the largest position; a
                    # graph being captured cannot read the host, and takes
                    # the seq-len table (right while positions < seq_len)
                    seq_len = max(seq_len, int(pos.max()) + 1)
            s, c = _sin_cos(seq_len, head_dim, rotary_emb_base, a.device)
        s = s.reshape(-1, s.shape[-1]).to(a.device)
        c = c.reshape(-1, c.shape[-1]).to(a.device)
        if pos is not None:
            idx = pos.reshape(-1).long().to(a.device)
            s = s[idx].reshape(tuple(pos.shape) + (s.shape[-1],))
            c = c[idx].reshape(tuple(pos.shape) + (c.shape[-1],))
            s, c = s[:, :, None, :], c[:, :, None, :]
        else:
            s, c = s[None, :, None, :], c[None, :, None, :]
        return s.float(), c.float()

    def rope_one(a, s, c):
        af = a.float()
        if use_neox_rotary_style:
            out = af * c + _rotate_half(af) * s
        else:
            # interleaved (GPT-J) style
            a1 = af[..., 0::2]
            a2 = af[..., 1::2]
            half = a.shape[-1] // 2
            ch, sh = c[..., :half], s[..., :half]
            o1 = a1 * ch - a2 * sh
            o2 = a2 * ch + a1 * sh
            out = torch.stack([o1, o2], dim=-1).reshape(af.shape)
        return out.to(a.dtype)

    outs = []
    for t in (q, k, v):
        if t is None:
            outs.append(None)
            continue

        def f(a):
            s, c = build(a, a.shape[1], a.shape[-1])
            return rope_one(a, s, c)
        outs.append(apply_op("fused_rope", f, t))
    return tuple(outs)


def rotary_embedding_sin_cos(seq_len, head_dim, base=10000.0,
                             dtype=torch.float32):
    """The (sin, cos) tables [seq_len, head_dim] as torch tensors on the
    current place."""
    from ...core.device import current_device
    from ...core.dtype import convert_dtype
    s, c = _sin_cos(seq_len, head_dim, base, current_device())
    dt = convert_dtype(dtype)
    return s.to(dt), c.to(dt)
