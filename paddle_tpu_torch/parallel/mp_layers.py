"""Tensor-parallel (Megatron) layers: counterpart of
``paddle_tpu/parallel/mp_layers.py`` (reference: python/paddle/distributed/
fleet/layers/mpu/mp_layers.py — VocabParallelEmbedding:49,
ColumnParallelLinear:336, RowParallelLinear:543, ParallelCrossEntropy:744;
comm ops mp_ops.py).

As in the reference, each layer places its parameters on the hybrid mesh's
'mp' axis (``_shard_param``) and constrains its activations
(``_constrain``); the placement is a DTensor's, and DTensor's sharding
propagation inserts the all-reduce / all-gather.  The layer API
(gather_output, input_is_parallel, ...) is preserved.

Two functions take a vocabulary-sharded tensor the way the reference's
reference does by hand, shard by shard: :func:`vocab_parallel_lookup`
(``F.embedding`` of a vocabulary-sharded table: each rank looks up the ids
of its rows, zeros elsewhere, and the partial sums reduce) and
:func:`_pce_math` on sharded logits (the stable log-sum-exp's max and sum
and the label's logit reduced over the vocabulary shards, the gradient
softmax - one-hot computed on each shard), so no ``[tokens, vocab]``
tensor is ever gathered.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import sharding
from ..core.tensor import Tensor
from ..core.dispatch import apply_op, unwrap
from ..nn.layer.layers import Layer
from ..nn.initializer import XavierUniform, Constant
from ..nn import functional as F
from ..distributed.fleet.topology import get_hybrid_communicate_group
from ..distributed.auto_parallel.api import distribute, place_param
from ._compat import P, spec_to_placements


def _mp_mesh():
    hcg = get_hybrid_communicate_group()
    return hcg.get_mesh()


def _fit(shape, spec, mesh):
    """``spec``'s entries, with dims that don't divide evenly across their
    mesh axes replicated."""
    sizes = dict(zip(mesh.dim_names, mesh.shape))
    entries = list(spec) + [None] * (len(shape) - len(tuple(spec)))
    for d, e in enumerate(entries):
        if e is None:
            continue
        axes = e if isinstance(e, tuple) else (e,)
        n = int(np.prod([sizes[a] for a in axes]))
        if shape[d] % n != 0:
            entries[d] = None
    return spec_to_placements(P(*entries), mesh.dim_names, len(shape))


def _shard_param(p: Tensor, spec: P):
    mesh = _mp_mesh()
    if np.prod(mesh.shape) == 1:
        return p
    return place_param(p, mesh, _fit(tuple(p.shape), spec, mesh))


def _constrain(x, spec: P):
    mesh = _mp_mesh()
    if np.prod(mesh.shape) == 1:
        return x
    placements = _fit(tuple(x.shape), spec, mesh)
    return apply_op("sharding_constraint",
                    lambda a: distribute(a, mesh, placements), x)


class VocabParallelEmbedding(Layer):
    """Vocab dim sharded over mp; out-of-shard lookups resolve via GSPMD gather
    (the reference masks + allreduces explicitly, mp_layers.py:49)."""

    def __init__(self, num_embeddings, embedding_dim, weight_attr=None, mp_group=None,
                 name=None):
        super().__init__()
        self._num_embeddings, self._embedding_dim = num_embeddings, embedding_dim
        self.weight = self.create_parameter([num_embeddings, embedding_dim],
                                            attr=weight_attr,
                                            default_initializer=XavierUniform())
        _shard_param(self.weight, P("mp", None))

    def forward(self, x):
        return F.embedding(x, self.weight)


class ColumnParallelLinear(Layer):
    """W [in, out] sharded on out (mp); y local-sharded unless gather_output."""

    def __init__(self, in_features, out_features, weight_attr=None, has_bias=True,
                 gather_output=True, fuse_matmul_bias=False, mp_group=None, name=None):
        super().__init__()
        self._gather_output = gather_output
        self.weight = self.create_parameter([in_features, out_features],
                                            attr=weight_attr,
                                            default_initializer=XavierUniform())
        _shard_param(self.weight, P(None, "mp"))
        self.bias = None
        if has_bias:
            self.bias = self.create_parameter([out_features], is_bias=True)
            _shard_param(self.bias, P("mp"))

    def forward(self, x):
        y = F.linear(x, self.weight, self.bias)
        if self._gather_output:
            return _constrain(y, P())  # gather shards -> replicated
        return _constrain(y, P(*([None] * (y.ndim - 1) + ["mp"])))


class RowParallelLinear(Layer):
    """W [in, out] sharded on in (mp); partial sums all-reduced by GSPMD."""

    def __init__(self, in_features, out_features, weight_attr=None, has_bias=True,
                 input_is_parallel=False, fuse_matmul_bias=False, mp_group=None,
                 name=None):
        super().__init__()
        self._input_is_parallel = input_is_parallel
        self.weight = self.create_parameter([in_features, out_features],
                                            attr=weight_attr,
                                            default_initializer=XavierUniform())
        _shard_param(self.weight, P("mp", None))
        self.bias = None
        if has_bias:
            self.bias = self.create_parameter([out_features], is_bias=True)

    def forward(self, x):
        if self._input_is_parallel:
            x = _constrain(x, P(*([None] * (x.ndim - 1) + ["mp"])))
        y = F.linear(x, self.weight, self.bias)
        return _constrain(y, P())


class ParallelCrossEntropy(Layer):
    """reference mp_layers.py:744 (c_softmax_with_cross_entropy over the
    vocab shard).

    The logits stay VOCAB-SHARDED end to end: the stable log-sum-exp's max
    and sum reductions over the sharded axis lower to psums on ICI, and the
    label term is a one-hot contraction (shard-local multiply + the same
    reduction) rather than a gather — so no [B, S, V] replicated tensor is
    ever materialized (the reference's c_softmax_with_cross_entropy does the
    identical two-allreduce dance by hand)."""

    def __init__(self, mp_group=None, name=None, ignore_index=-100):
        super().__init__()
        self._ignore_index = ignore_index

    def forward(self, input, label):
        ignore = self._ignore_index
        input = _constrain(
            input, P(*([None] * (input.ndim - 1) + ["mp"])))
        return apply_op("parallel_cross_entropy",
                        lambda x, y: _pce_math(x, y, ignore), input, label)


def _pce_math(x, y, ignore=-100):
    """The shard-local CE math: per-token loss, 0 at ``ignore``.  Sharded
    logits go through :func:`_vocab_parallel_ce`, which reduces over the
    vocabulary shards and never gathers them."""
    if sharding.is_sharded(x):
        return _vocab_parallel_ce(x, y, ignore)
    return _VocabParallelCE.apply(x, y, 0, None, ignore)


class _VocabParallelCE(torch.autograd.Function):
    """Cross entropy of logits whose last axis is this rank's shard
    (starting at vocabulary id ``start``) of a vocabulary split over
    ``group`` (None: the whole vocabulary): the max, the sum of
    exponentials and the label's logit are all-reduced; the backward is
    (softmax - one-hot) * grad on the shard, with no communication."""

    @staticmethod
    def forward(ctx, x, y, start, group, ignore):
        import torch.distributed as dist
        xf = x.float()
        m = xf.amax(-1, keepdim=True)
        if group is not None:
            dist.all_reduce(m, op=dist.ReduceOp.MAX, group=group)
        e = torch.exp(xf - m)
        s = e.sum(-1, keepdim=True)
        loc = y.long() - start
        inside = (loc >= 0) & (loc < x.shape[-1])
        lc = torch.where(inside, loc, 0)
        picked = torch.where(inside, xf.gather(-1, lc[..., None])[..., 0], 0.0)
        if group is not None:
            dist.all_reduce(s, group=group)
            dist.all_reduce(picked, group=group)
        loss = torch.log(s[..., 0]) + m[..., 0] - picked
        keep = torch.ones_like(inside) if ignore is None else y != ignore
        loss = torch.where(keep, loss, 0.0)
        ctx.save_for_backward(e, s, lc, inside, keep)
        ctx.dtype = x.dtype
        return loss

    @staticmethod
    def backward(ctx, g):
        e, s, lc, inside, keep = ctx.saved_tensors
        p = e / s
        p.scatter_add_(-1, lc[..., None], -inside.to(p.dtype)[..., None])
        gx = p * torch.where(keep, g, 0.0)[..., None]
        return gx.to(ctx.dtype), None, None, None, None


def _batch_placements(x):
    """The placements of a per-token value of logits ``x``: x's shards of
    the leading axes (strided ones too: a sequence split on 'sep' flattened
    with the batch), replicated over its vocabulary shards."""
    from torch.distributed.tensor import Replicate
    last = x.ndim - 1
    return [p if not (p.is_replicate() or p.is_partial())
            and p.dim % x.ndim != last else Replicate()
            for p in x.placements]


def _local_labels(y, x, placements):
    """The labels of this rank's tokens of ``x``, as a plain tensor."""
    from torch.distributed.tensor import DTensor, Replicate
    dm = x.device_mesh
    if not isinstance(y, DTensor):
        y = DTensor.from_local(y, dm, [Replicate()] * dm.ndim,
                               run_check=False)
    return y.redistribute(dm, placements).to_local()


def _vocab_parallel_ce(x, y, ignore):
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    dm, last = x.device_mesh, x.ndim - 1
    vocab = [i for i, p in enumerate(x.placements)
             if p.is_shard() and p.dim % x.ndim == last]
    if len(vocab) > 1:
        raise NotImplementedError(
            "cross entropy of logits whose vocabulary is split over more "
            "than one mesh axis")
    yp = _batch_placements(x)
    y_l = _local_labels(y, x, yp)
    _, offset = compute_local_shape_and_global_offset(x.shape, dm,
                                                      x.placements)
    group = dm.get_group(vocab[0]) if vocab else None
    loss = _VocabParallelCE.apply(x.to_local(), y_l, offset[last], group,
                                  ignore)
    return DTensor.from_local(loss, dm, yp, run_check=False)


def vocab_parallel_lookup(idx, w):
    """``embedding(idx, w)`` of a table ``w`` sharded by rows (the
    reference's masked lookup + all-reduce, mp_layers.py:49): each rank
    looks up the ids in its rows, zeros elsewhere, and the result is a
    pending sum over the row shards (reduced by the next read).  Shards of
    the table's columns are gathered first."""
    import torch.nn.functional as TF
    from torch.distributed.tensor import DTensor, Partial, Replicate
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    dm = w.device_mesh
    if any(p.is_shard() and p.dim % 2 == 1 for p in w.placements):
        w = w.redistribute(dm, [Replicate() if p.is_shard() and p.dim % 2 == 1
                                else p for p in w.placements])
    rows = [p.is_shard() for p in w.placements]
    if isinstance(idx, DTensor):
        ip = [Replicate() if r or not p.is_shard() else p
              for r, p in zip(rows, idx.placements)]
        idx = idx.redistribute(dm, ip)
        idx_l = idx.to_local()
    else:
        ip = [Replicate()] * dm.ndim
        idx_l = idx
    _, offset = compute_local_shape_and_global_offset(w.shape, dm,
                                                      w.placements)
    # where the ids are split (a batch over 'dp'), this rank's table gradient
    # covers its own ids only: a partial sum over that axis
    lw = w.to_local(grad_placements=[Partial() if p.is_shard() else q
                                     for p, q in zip(ip, w.placements)])
    loc = idx_l.long() - offset[0]
    inside = (loc >= 0) & (loc < lw.shape[0])
    out = TF.embedding(torch.where(inside, loc, 0), lw)
    out = out * inside[..., None].to(out.dtype)
    pl = [Partial() if r else p for r, p in zip(rows, ip)]
    return DTensor.from_local(out, dm, pl, run_check=False)


class RNGStatesTracker:
    """TP-aware RNG (reference: fleet/layers/mpu/random.py:34).

    Under the single-controller GSPMD model, one global key already yields
    identical masks on every shard of replicated activations and distinct
    per-position randomness on sharded ones — so the tracker only needs to
    provide named alternate streams.
    """

    def __init__(self):
        self._states = {}

    def add(self, name, seed):
        from ..core.rng import Generator
        if name in self._states:
            raise ValueError(f"rng state {name} already exists")
        self._states[name] = Generator(seed)

    def get_states_tracker(self):
        return dict(self._states)

    def set_states_tracker(self, states):
        self._states = dict(states)

    def rng_state(self, name="model_parallel_rng"):
        import contextlib

        @contextlib.contextmanager
        def cm():
            from ..core import rng as rng_mod
            if name not in self._states:
                self.add(name, np.random.randint(0, 2 ** 31 - 1))
            prev = rng_mod._default_generator
            rng_mod._default_generator = self._states[name]
            try:
                yield
            finally:
                rng_mod._default_generator = prev
        return cm()


_RNG_TRACKER = RNGStatesTracker()


def get_rng_state_tracker():
    return _RNG_TRACKER


def model_parallel_random_seed(seed=None):
    import random as pyrandom
    global _RNG_TRACKER
    _RNG_TRACKER = RNGStatesTracker()
    basic = seed if seed is not None else pyrandom.randint(0, 2 ** 30)
    from ..core.rng import seed as set_seed
    set_seed(basic)
    _RNG_TRACKER.add("model_parallel_rng", basic + 1024)
