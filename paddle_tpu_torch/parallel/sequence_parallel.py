"""Megatron sequence parallelism: counterpart of
``paddle_tpu/parallel/sequence_parallel.py`` (reference: python/paddle/distributed/fleet/
utils/sequence_parallel_utils.py — ColumnSequenceParallelLinear:429,
RowSequenceParallelLinear:564, AllGatherOp:111, ReduceScatterOp:127).

As in the reference, SP is a sharding choice — activations carry
Shard(seq_dim) on the 'mp' axis outside the matmul blocks — here a DTensor
placement, whose boundary redistributions are the all-gather /
reduce-scatter pair the reference codes by hand.
"""
from __future__ import annotations

import numpy as np

from ..core.tensor import Tensor
from ..core.dispatch import apply_op
from ..nn.layer.layers import Layer
from ..nn.initializer import XavierUniform
from ..nn import functional as F
from ._compat import P
from .mp_layers import _mp_mesh, _shard_param, _constrain


def _seq_spec(ndim, seq_axis=1):
    entries = [None] * ndim
    entries[seq_axis] = "mp"
    return P(*entries)


class AllGatherOp(Layer):
    """seq-sharded -> replicated (reference :111)."""

    def forward(self, x):
        return _constrain(x, P())


class ReduceScatterOp(Layer):
    """partial/replicated -> seq-sharded (reference :127)."""

    def forward(self, x):
        return _constrain(x, _seq_spec(x.ndim))


def scatter(x, seq_axis=1):
    return _constrain(x, _seq_spec(x.ndim, seq_axis))


def all_gather(x):
    return _constrain(x, P())


class ColumnSequenceParallelLinear(Layer):
    def __init__(self, in_features, out_features, weight_attr=None, has_bias=True,
                 gather_output=False, fuse_matmul_bias=False, mp_group=None, name=None):
        super().__init__()
        self.weight = self.create_parameter([in_features, out_features],
                                            attr=weight_attr,
                                            default_initializer=XavierUniform())
        _shard_param(self.weight, P(None, "mp"))
        self.bias = self.create_parameter([out_features], is_bias=True) if has_bias else None
        if self.bias is not None:
            _shard_param(self.bias, P("mp"))

    def forward(self, x):
        # input arrives seq-sharded; GSPMD emits the all-gather before the matmul
        y = F.linear(x, self.weight, self.bias)
        return _constrain(y, P(*([None] * (y.ndim - 1) + ["mp"])))


class RowSequenceParallelLinear(Layer):
    def __init__(self, in_features, out_features, weight_attr=None, has_bias=True,
                 input_is_parallel=True, fuse_matmul_bias=False, mp_group=None,
                 name=None):
        super().__init__()
        self.weight = self.create_parameter([in_features, out_features],
                                            attr=weight_attr,
                                            default_initializer=XavierUniform())
        _shard_param(self.weight, P("mp", None))
        self.bias = self.create_parameter([out_features], is_bias=True) if has_bias else None

    def forward(self, x):
        y = F.linear(x, self.weight, self.bias)
        # partial-sum output reduce-scatters onto the seq dim
        return _constrain(y, _seq_spec(y.ndim))


def mark_as_sequence_parallel_parameter(parameter):
    parameter.sequence_parallel = True


def is_sequence_parallel_parameter(parameter):
    return getattr(parameter, "sequence_parallel", False)


def register_sequence_parallel_allreduce_hooks(model, accumulation_steps=1,
                                               fuse_sequence_parallel_allreduce=False):
    """reference :192 — the gradient reduction of SP parameters comes from
    their placements (DTensor's redistributions); nothing to hook."""
    return model
