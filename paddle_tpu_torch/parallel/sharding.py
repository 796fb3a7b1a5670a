"""ZeRO / sharding stages: counterpart of ``paddle_tpu/parallel/sharding.py``
(reference: fleet/meta_optimizers/dygraph_optimizer/
dygraph_sharding_optimizer.py:54 (stage 1), fleet/meta_parallel/sharding/
group_sharded_stage2.py:47, group_sharded_stage3.py:85; facade
python/paddle/distributed/sharding/group_sharded.py).

As in the reference, each ZeRO stage is a placement policy over the
'sharding' mesh axis, one process a rank:

- stage 1 (``os``) and stage 2 (``os_g``) shard the optimizer's state: each
  rank of the axis updates the rows of every parameter (whose leading
  dimension divides) it owns, keeping those rows' moments only, and the
  updated rows are all-gathered (``Optimizer._views``);
- stage 3 (``p_g_os``) also shards the parameters themselves (FSDP): each
  divisible parameter becomes a DTensor sharded by rows; every op that
  reads it gets it gathered (one all-gather a use) and its gradient is
  reduce-scattered back to the rank's rows (``gather_sharded``), the
  reference's pattern (gather the parameters, reduce-scatter the
  gradients), so no activation is a partial sum of sharded weights.
"""
from __future__ import annotations

import numpy as np

from ..distributed.fleet.topology import get_hybrid_communicate_group
from ..distributed.auto_parallel.api import place_param
from ._compat import P, spec_to_placements


def _shard_spec_for(shape, axis="sharding", mesh=None):
    """Shard dim 0 if divisible by the axis size, else replicate."""
    n = mesh.get_dim_size(axis)
    if shape and shape[0] % n == 0 and shape[0] >= n:
        return P(*([axis] + [None] * (len(shape) - 1)))
    return P()


def _axis_size(mesh, axis):
    return mesh.get_dim_size(axis) if axis in mesh.dim_names else 1


def shard_accumulators(optimizer, axis="sharding", mesh=None):
    """ZeRO-1: each rank of the axis keeps and updates its rows of every
    optimizer accumulator."""
    pmesh = mesh or get_hybrid_communicate_group().get_mesh()
    if _axis_size(pmesh, axis) == 1:
        return optimizer
    dm = pmesh.device_mesh()
    if dm is None:
        return optimizer
    optimizer._state_shards = (dm.get_group(axis), dm.size(dm.mesh_dim_names.index(axis)),
                               dm.get_local_rank(axis))
    return optimizer


def shard_parameters(model, axis="sharding", mesh=None):
    """ZeRO-3: shard parameter storage on the axis (FSDP)."""
    pmesh = mesh or get_hybrid_communicate_group().get_mesh()
    if _axis_size(pmesh, axis) == 1:
        return model
    for p in model.parameters():
        spec = _shard_spec_for(tuple(p.shape), axis, pmesh)
        place_param(p, pmesh, spec_to_placements(spec, pmesh.dim_names,
                                                 p.ndim))
        gather_sharded(p, axis)
    return model


def gather_sharded(p, axis):
    """Have every op that reads ``p`` gather it on ``axis`` if it is stored
    sharded there (``core.sharding.gather_on_use``): the forward all-gathers
    the weight and the backward reduce-scatters its gradient to the rank's
    rows, Paddle's stage-3 traffic."""
    from ..core import sharding
    buf = p._buf
    if not sharding.is_sharded(buf):
        return
    dm = buf.device_mesh
    if axis in (dm.mesh_dim_names or ()):
        d = dm.mesh_dim_names.index(axis)
        if buf.placements[d].is_shard():
            sharding.gather_on_use(p, [d])


class DygraphShardingOptimizer:
    """ZeRO stage-1 wrapper (reference dygraph_sharding_optimizer.py:54)."""

    def __init__(self, optimizer, hcg=None):
        self._inner_opt = shard_accumulators(optimizer)
        self._hcg = hcg

    def __getattr__(self, name):
        return getattr(self.__dict__["_inner_opt"], name)

    def step(self):
        self._inner_opt.step()

    def clear_grad(self, set_to_zero=False):
        self._inner_opt.clear_grad(set_to_zero)


class GroupShardedOptimizerStage2(DygraphShardingOptimizer):
    """reference group_sharded_optimizer_stage2.py:53 — optimizer whose
    states live sharded on the sharding axis (same placement policy as
    stage 1; gradients inherit it inside the compiled step).

    Accepts the reference call shape (params, optim, group) as well as the
    stage-1 wrapper's (optimizer, hcg)."""

    def __init__(self, params=None, optim=None, group=None, **kw):
        opt = optim if optim is not None and hasattr(optim, "_acc") else \
            (params if hasattr(params, "_acc") else optim)
        if opt is None or not hasattr(opt, "_acc"):
            raise TypeError("GroupShardedOptimizerStage2 needs an optimizer "
                            "(reference signature: params, optim, group)")
        super().__init__(opt)


class _ShardedModelWrapper:
    """Model wrapper matching the reference GroupShardedStage2/3 call shape:
    wraps the layer, delegates forward/state_dict, and applies the stage's
    placement policy. The reduce-scatter/all-gather traffic the reference
    hand-codes comes from DTensor's redistributions and the optimizer's
    gather of its rows."""

    def __init__(self, layer, optimizer=None, group=None, sync_buffers=False,
                 **kw):
        self._layers = layer
        self._optimizer = optimizer

    def __call__(self, *args, **kwargs):
        return self._layers(*args, **kwargs)

    def forward(self, *args, **kwargs):
        return self._layers(*args, **kwargs)

    def parameters(self, *a, **k):
        return self._layers.parameters(*a, **k)

    def state_dict(self, *a, **k):
        return self._layers.state_dict(*a, **k)

    def set_state_dict(self, sd, *a, **k):
        return self._layers.set_state_dict(sd, *a, **k)

    def train(self):
        self._layers.train()
        return self

    def eval(self):
        self._layers.eval()
        return self

    def __getattr__(self, item):
        return getattr(self.__dict__["_layers"], item)


class GroupShardedStage2(_ShardedModelWrapper):
    """reference group_sharded_stage2.py:47 — grad + optimizer-state
    sharding: wraps the model and shards the optimizer's accumulators (each
    rank updates its rows from its rows of the gradient)."""

    def __init__(self, layer, sharding_optimizer=None, group=None,
                 sync_buffers=False, buffer_max_size=2 ** 23, **kw):
        super().__init__(layer, sharding_optimizer, group)
        if sharding_optimizer is not None and not isinstance(
                sharding_optimizer, DygraphShardingOptimizer):
            shard_accumulators(sharding_optimizer)


class GroupShardedStage3(_ShardedModelWrapper):
    """reference group_sharded_stage3.py:85 — parameter sharding (FSDP):
    wraps the model, shards parameter storage AND optimizer state."""

    def __init__(self, layer, optimizer=None, group=None, sync_buffers=False,
                 segment_size=2 ** 20, offload=False, **kw):
        super().__init__(layer, optimizer, group)
        shard_parameters(layer)
        if optimizer is not None:
            shard_accumulators(optimizer)


def group_sharded_parallel(model, optimizer, level="p_g_os", scaler=None,
                           group=None, offload=False, sync_buffers=False,
                           buffer_max_size=2 ** 23, segment_size=2 ** 20,
                           sync_comm=False, dp_group=None, exclude_layer=None):
    """reference: python/paddle/distributed/sharding/group_sharded.py.

    level: 'os' (stage1) | 'os_g' (stage2) | 'p_g_os' (stage3/FSDP).
    """
    if level in ("os", "os_g", "p_g_os"):
        optimizer = shard_accumulators(optimizer)
    if level == "p_g_os":
        model = shard_parameters(model)
    if scaler is not None:
        return model, optimizer, scaler
    return model, optimizer


def save_group_sharded_model(model, output, optimizer=None):
    """Every rank calls it: the parameters are gathered (a sharded one's
    ``.numpy()`` is a collective) and rank 0 writes ``output.pdparams``; the
    optimizer's state is each rank's own rows, written by each rank to
    ``output.pdopt`` (one rank) or ``output.pdopt.<rank>``."""
    from ..framework.io import save
    from ..core import sharding
    from ..core.tensor import _wrap
    from ..distributed.env import get_rank, get_world_size
    state = {k: _wrap(sharding.full(v._buf.detach()))
             for k, v in model.state_dict().items()}
    if get_rank() == 0:
        save(state, output + ".pdparams")
    if optimizer is not None:
        suffix = "" if get_world_size() == 1 else f".{get_rank()}"
        save(optimizer.state_dict(), output + ".pdopt" + suffix)
