"""SPMD pipeline schedule over the 'pp' mesh axis: counterpart of
``paddle_tpu/parallel/pipeline.py`` (SURVEY §7: "PP = stage-partitioned
program + collective_permute microbatch schedule"; reference semantics:
fleet/meta_parallel/pipeline_parallel.py, 1F1B :575, interleave :1179,
built on NCCL p2p).

Every stage rank runs the same program: the stage weights are stacked on a
leading [pp] dim, each rank of the 'pp' axis takes its stage's slice, and
each tick runs the stage and hands its output to the next stage with
``mesh_ppermute`` (differentiable: the gradient rides back along the
inverse ring).  A GPipe fill-drain over M microbatches completes in
M + P - 1 ticks.  One process is one rank, so the ring is real
point-to-point traffic between the stage processes; in a single process
(no 'pp' group) every stage runs in turn.

This powers the homogeneous-transformer path; the generic host-driven
PipelineLayer container lives in pipeline_layer.py.
"""
from __future__ import annotations

import torch

from ..core.tensor import Tensor
from ..core.dispatch import apply_op, unwrap
from ..distributed.collective import mesh_ppermute, _axis_group


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in tree for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


class _FromLast(torch.autograd.Function):
    """The last stage's value on every rank of the group (a broadcast);
    the gradient of the replicated result, which every rank computes alike,
    goes back to the last stage once."""

    @staticmethod
    def forward(ctx, y, g, last):
        import torch.distributed as dist
        ctx.mine = g.get_rank() == last
        out = y.detach().clone().contiguous()
        dist.broadcast(out, g.ranks[last], group=g.pg)
        return out

    @staticmethod
    def backward(ctx, gout):
        return (gout if ctx.mine else torch.zeros_like(gout)), None, None


def pipeline_forward(stage_fn, stacked_params, x_micro, *, mesh=None,
                     axis_name="pp"):
    """Run microbatched GPipe forward.

    stage_fn(params_slice, x) -> y        (same shapes for x and y)
    stacked_params: pytree with leading [P] dim on every leaf (stage-major):
      each rank of the axis runs its own stage's slice (the gradient of the
      others' slices is zero on this rank)
    x_micro: [M, B, ...] microbatches (already embedded — homogeneous stages)
    returns [M, B, ...] outputs from the LAST stage (replicated).
    """
    g = _axis_group(axis_name)
    leaves = _leaves(stacked_params)
    P_ = int(leaves[0].shape[0])
    M = x_micro.shape[0]
    if g.pg is None or g.nranks == 1:
        # one process: every stage in turn, microbatch by microbatch
        outs = []
        for m in range(M):
            h = x_micro[m]
            for s in range(P_):
                h = stage_fn(_tree_map(lambda a: a[s], stacked_params), h)
            outs.append(h)
        return torch.stack(outs)
    if g.nranks != P_:
        raise ValueError(f"{P_} stacked stages over a '{axis_name}' axis of "
                         f"{g.nranks} ranks")
    idx = g.get_rank()
    params = _tree_map(lambda a: a[idx], stacked_params)
    n_ticks = M + P_ - 1
    perm = [(i, (i + 1) % P_) for i in range(P_)]
    buf = torch.zeros_like(x_micro[0])
    outs = [None] * M
    for t in range(n_ticks):
        # stage 0 ingests microbatch t (when valid); the others their input.
        # Stage 0 still reads what arrived, times zero, as the reference
        # does: every rank's ppermute then has a gradient, so each backward
        # exchange has its partner on the other side
        if idx == 0:
            inject = 1.0 if t < M else 0.0
            x_in = x_micro[min(t, M - 1)] * inject + buf * 0.0
        else:
            x_in = buf
        y = stage_fn(params, x_in)
        # last stage's output for microbatch (t - (P-1)) is ready at tick t
        m_out = t - (P_ - 1)
        if 0 <= m_out < M:
            outs[m_out] = y
        if t + 1 < n_ticks:
            buf = mesh_ppermute(y, axis_name, perm)
    out = torch.stack(outs)
    return _FromLast.apply(out, g, P_ - 1)


def pipeline_call(stage_fn, stacked_params, x_micro, mesh=None,
                  axis_name="pp"):
    """Tensor-level wrapper with autograd through the schedule."""
    tensor_leaves = [t for t in _leaves(stacked_params)
                     if isinstance(t, Tensor)]

    def f(x, *param_leaves):
        it = iter(param_leaves)
        params = _tree_map(lambda t: next(it) if isinstance(t, Tensor)
                           else unwrap(t), stacked_params)
        return pipeline_forward(stage_fn, params, x, mesh=mesh,
                                axis_name=axis_name)

    return apply_op("pipeline", f, x_micro, *tensor_leaves)
