"""Mixture-of-Experts with expert parallelism: counterpart of
``paddle_tpu/parallel/moe.py`` (reference:
python/paddle/incubate/distributed/models/moe/moe_layer.py:263 MoELayer using
global_scatter/global_gather all-to-all; gate kernels phi/kernels/*number_count,
limit_by_capacity, random_routing; spmd rules moe_gate_dispatch/moe_combine).

As in the reference, the experts' weights are stacked [E, ...] and placed on
the dedicated 'ep' mesh axis when the hybrid topology has one (falling back
to 'mp' on pre-ep meshes), with the expert FFN hidden dim on 'mp' so TP and
EP compose.  Token dispatch is the dense capacity-bucketed einsum
(GShard-style); the expert-major tokens are constrained to the experts'
placement, so each rank runs its own experts, and the combine's partial sums
over the expert shards reduce (DTensor inserts the collectives as GSPMD
does).  The gate computes on every token on every rank (its capacity
positions are a cumulative sum over all tokens).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as TF

from ..core import sharding
from ..core.tensor import Tensor
from ..core.dispatch import apply_op, unwrap
from ..nn.layer.layers import Layer
from ..nn.initializer import XavierUniform
from ..nn import functional as F
from ._compat import P
from .mp_layers import _mp_mesh, _shard_param, _constrain


def _expert_axes():
    """(ep_axis, tp_axis) for expert sharding on the current mesh: experts go
    on 'ep' when the mesh has one (size>1), else 'mp' (pre-ep 5-axis
    topologies); the expert FFN hidden dim additionally shards on 'mp' only
    when ep and mp are both active (TP x EP composition)."""
    mesh = _mp_mesh()
    sizes = dict(zip(mesh.dim_names, mesh.shape))
    if sizes.get("ep", 1) > 1:
        return "ep", ("mp" if sizes.get("mp", 1) > 1 else None)
    return "mp", None


def topk_gating(logits, capacity, k=2):
    """GShard-style top-k gating: returns (combine [S,E,C], dispatch mask,
    aux_loss). Generalizes the classic top-2 — slot s assigns each token its
    s-th-choice expert, capacity-limited by cumsum position after the prior
    slots' assignments (reference's number_count/limit_by_capacity/assign_pos
    kernels collapse into this cumsum math; top-k for the DeepSeekMoE/Qwen2
    top-6/top-8 routers).

    logits: [S, E] float32 (a torch tensor). Dense: no host reads.
    """
    S, E = logits.shape
    k = min(k, E)     # argmax over an exhausted row would re-pick expert 0
    f32 = torch.float32
    probs = torch.softmax(logits.to(f32), dim=-1)
    remaining = probs
    prior = torch.zeros((E,), dtype=f32, device=logits.device)
    combine = torch.zeros((S, E, capacity), dtype=f32, device=logits.device)
    gsum = torch.zeros((S,), dtype=f32, device=logits.device)
    slots = torch.arange(capacity, device=logits.device)
    aux_loss = None
    for slot in range(k):
        idx = torch.argmax(remaining, dim=-1)
        mask = TF.one_hot(idx, E).to(f32)
        remaining = remaining * (1 - mask)
        if slot == 0:
            # aux load-balancing loss (Switch/GShard): top-1 density
            density = torch.mean(mask, dim=0)
            density_proxy = torch.mean(probs, dim=0)
            aux_loss = torch.sum(density * density_proxy) * E
        pos = (torch.cumsum(mask, dim=0) - 1 + prior) * mask
        mask = mask * (pos < capacity)
        prior = prior + torch.sum(mask, dim=0)
        g = torch.sum(probs * mask, dim=-1)
        loc = torch.sum(pos, dim=-1).to(torch.int32)
        sel = torch.sum(mask, dim=-1)
        # a one-hot of the slot; a position past the capacity has none
        cap_oh = (loc[:, None] == slots).to(f32) * sel[:, None]
        combine = combine + (g[:, None, None] * mask[:, :, None]
                             * cap_oh[:, None, :])
        gsum = gsum + g
    combine = combine / torch.clamp(gsum, min=1e-9)[:, None, None]
    dispatch = combine > 0
    return combine, dispatch, aux_loss


def top2_gating(logits, capacity):
    """Classic GShard top-2 (kept as the named entry point)."""
    return topk_gating(logits, capacity, k=2)


class ExpertMLP(Layer):
    """Stacked experts: weights [E, in, hidden] / [E, hidden, in] sharded on mp."""

    def __init__(self, num_experts, d_model, d_hidden, activation=F.gelu):
        super().__init__()
        self.w1 = self.create_parameter([num_experts, d_model, d_hidden],
                                        default_initializer=XavierUniform())
        self.w2 = self.create_parameter([num_experts, d_hidden, d_model],
                                        default_initializer=XavierUniform())
        self.ep_axis, tp = _expert_axes()
        _shard_param(self.w1, P(self.ep_axis, None, tp))
        _shard_param(self.w2, P(self.ep_axis, tp, None))
        self.act = activation

    def forward(self, x):
        """x: [E, C, d_model] expert-major tokens -> [E, C, d_model]."""
        def mlp(a, w1, w2):
            h = torch.einsum("ecm,emh->ech", a, w1.to(a.dtype))
            h = TF.gelu(h, approximate="tanh")     # the reference's gelu
            return torch.einsum("ech,ehm->ecm", h, w2.to(a.dtype))

        def f(a, w1, w2):
            if not sharding.is_sharded(w1):
                return mlp(a, w1, w2)
            # each rank runs its experts' rows (and its slice of the hidden
            # dim where 'mp' splits it: a partial sum over 'mp')
            from torch.distributed.tensor import (DTensor, Partial, Replicate,
                                                  Shard)
            dm = w1.device_mesh
            rows = [Shard(0) if p.is_shard(0) else Replicate()
                    for p in w1.placements]
            hid = [p.is_shard(2) for p in w1.placements]
            a = a if sharding.is_sharded(a) else sharding.replicated(a, dm)
            a = a.redistribute(dm, rows).to_local(grad_placements=[
                Partial() if h else p for h, p in zip(hid, rows)])
            out = mlp(a, w1.to_local(), w2.to_local())
            return DTensor.from_local(out, dm, [Partial() if h else p for h, p
                                                in zip(hid, rows)],
                                      run_check=False)
        return apply_op("expert_mlp", f, x, self.w1, self.w2)


def _ep_dim(mesh, ep):
    """The device-mesh dimension of the experts' axis ``ep`` (None when
    nothing is sharded or the axis is not split)."""
    names = getattr(mesh, "mesh_dim_names", None) or ()
    return names.index(ep) if ep in names and mesh.size(names.index(ep)) > 1 \
        else None


def _local_rows(n, mesh, dim):
    """[lo, hi) of the rows of an n-row tensor this rank holds when it is
    sharded on mesh dimension ``dim`` (torch.chunk's split)."""
    k = mesh.size(dim)
    per = -(-n // k)
    lo = min(mesh.get_local_rank(dim) * per, n)
    return lo, min(lo + per, n)


class MoELayer(Layer):
    """reference: moe/moe_layer.py:263. GShard-style gate, top_k selectable
    (top-2 default; DeepSeek/Qwen2 MoE use 6/8)."""

    def __init__(self, d_model, experts=None, num_experts=8, d_hidden=None,
                 gate=None, moe_group=None, mp_group=None, recompute_interval=0,
                 capacity_factor=1.25, top_k=2, name=None):
        super().__init__()
        self.num_experts = num_experts
        self.d_model = d_model
        self.capacity_factor = capacity_factor
        self.top_k = int(top_k)
        self.gate_w = self.create_parameter([d_model, num_experts],
                                            default_initializer=XavierUniform())
        self.experts = experts if experts is not None else \
            ExpertMLP(num_experts, d_model, d_hidden or 4 * d_model)
        self.aux_loss = None

    def forward(self, x):
        b, s, m = x.shape
        S = b * s
        E = self.num_experts
        # GShard capacity scales with the router fan-out: top-k dispatches
        # k*S assignments, so slots must scale by k or most are dropped
        C = int(np.ceil(self.capacity_factor * self.top_k * S / E))
        cap = C

        ep = getattr(self.experts, "ep_axis", None)
        if ep is None or ep not in _mp_mesh().dim_names:
            ep = _expert_axes()[0]

        def f(a, gw):
            # every rank gates every token (the capacity positions are a
            # cumulative sum over all of them)
            mesh = a.device_mesh if sharding.is_sharded(a) else None
            ed = _ep_dim(mesh, ep)
            if ed is not None and E % mesh.size(ed):
                ed = None
            if ed is None:
                a, mesh = sharding.replicated_local(a)
                flat = a.reshape(S, m)
                disp_in = flat
            else:
                from torch.distributed.tensor import Partial, Replicate
                rep = a.redistribute(mesh, [Replicate()] * mesh.ndim)
                flat = rep.to_local().reshape(S, m)
                # the dispatch below reads this rank's experts' tokens
                # only: its gradient is a partial sum over 'ep'
                disp_in = rep.to_local(grad_placements=[
                    Partial() if d == ed else Replicate()
                    for d in range(mesh.ndim)]).reshape(S, m)
            gw, _ = sharding.replicated_local(gw)
            logits = flat.to(torch.float32) @ gw.to(torch.float32)
            combine, dispatch, aux = topk_gating(logits, cap, self.top_k)
            if ed is None:
                # dispatch tokens -> [E, C, m]; the constraint below hands
                # each rank its experts' rows
                exp_in = torch.einsum("sec,sm->ecm", dispatch.to(a.dtype),
                                      disp_in)
                return tuple(sharding.replicated(t, mesh) for t in
                             (exp_in, combine.to(torch.float32), aux))
            # each rank dispatches to its own experts (tokens replicated
            # over 'ep': the GShard all-to-all has nothing to move)
            from torch.distributed.tensor import DTensor, Replicate, Shard
            lo, hi = _local_rows(E, mesh, ed)
            exp_in = DTensor.from_local(
                torch.einsum("sec,sm->ecm",
                             dispatch[:, lo:hi].to(disp_in.dtype), disp_in),
                mesh, [Shard(0) if d == ed else Replicate()
                       for d in range(mesh.ndim)], run_check=False)
            return (exp_in, sharding.replicated(combine.to(torch.float32),
                                                mesh),
                    sharding.replicated(aux, mesh))

        exp_in, combine, aux = apply_op("moe_dispatch", f, x, self.gate_w)
        exp_in = _constrain(exp_in, P(ep, None, None))
        exp_out = self.experts(exp_in)
        exp_out = _constrain(exp_out, P(ep, None, None))

        def g(eo, comb):
            if not sharding.is_sharded(eo):
                out = torch.einsum("sec,ecm->sm", comb.to(eo.dtype), eo)
                return out.reshape(b, s, m)
            # each rank combines its experts' outputs: a partial sum over
            # the expert shards.  The combine weights cross to the experts'
            # shards as [S, E] (a token's weight for an expert; its slot is
            # a constant), so their gradient gathers [S, E], not [S, E, C]
            from torch.distributed.tensor import (DTensor, Partial, Replicate,
                                                  Shard)
            dm = eo.device_mesh
            on_e = [p.is_shard(0) for p in eo.placements]
            if not any(on_e):
                eo, _ = sharding.replicated_local(eo)
                comb, _ = sharding.replicated_local(comb)
                out = torch.einsum("sec,ecm->sm", comb.to(eo.dtype), eo)
                return sharding.replicated(out.reshape(b, s, m), dm)
            comb = comb if sharding.is_sharded(comb) else \
                sharding.replicated(comb, dm)
            slot = (comb > 0).to_local().detach()
            w = comb.sum(-1).redistribute(dm, [Shard(1) if e else Replicate()
                                               for e in on_e]).to_local()
            lo, hi = _local_rows(E, dm, on_e.index(True))
            wc = w[:, :, None] * slot[:, lo:hi].to(w.dtype)
            out = torch.einsum("sec,ecm->sm", wc.to(eo.dtype), eo.to_local())
            return DTensor.from_local(out.reshape(b, s, m), dm,
                                      [Partial() if e else Replicate()
                                       for e in on_e], run_check=False)

        out = apply_op("moe_combine", g, exp_out, combine)
        self.aux_loss = apply_op("moe_aux", lambda l: l, aux)
        return out
