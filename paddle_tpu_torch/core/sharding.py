"""Sharded Tensors: the hooks that let a port ``Tensor`` hold a DTensor.

A Tensor whose buffer is a ``torch.distributed.tensor.DTensor`` reads as
the global tensor (``.shape``, ``.numpy()``) and its ops run through
DTensor's sharding propagation, as the reference's ops over a sharded
``jax.Array`` run through GSPMD.  Nothing here imports
``torch.distributed`` until :func:`activate` runs, which the distributed
package calls when it makes the first sharded tensor; until then each hook
costs one ``None`` check.

- :func:`activate` turns on DTensor's implicit replication for the process,
  once: a plain tensor that meets a DTensor in an op (a position table, a
  scalar of the optimizer, a weight left unsharded) counts as replicated,
  which it is, since every rank computes it alike.
- :func:`settle` is applied by ``apply_op`` to every op output: a pending
  partial sum is reduced at once (``Partial`` -> ``Replicate``), as GSPMD
  materializes a partial before the next op reads it; its backward reduces
  a pending partial sum of the gradient there too (Megatron's backward
  all-reduce), so no partial gradient reaches the ops before it, which
  DTensor would otherwise meet with gathers and reduce-scatters.
- :func:`gather_on_use` marks a parameter stored sharded (ZeRO-3, FSDP):
  ``apply_op`` hands each op that reads it the parameter gathered on those
  mesh dimensions (one all-gather a use), and the gradient returns to the
  rank's rows through the gather's backward (a reduce-scatter of a partial
  sum, the rank's chunk of a replicated one), so an activation is never a
  partial sum of sharded weights.
- :func:`rows_matmul` multiplies activations split along a leading
  dimension other than the first (a sequence over 'sep') by a weight on
  each rank's rows: DTensor's matmul folds the leading dimensions, which
  it cannot do across a split one (torch 2.11 refuses it).
- :func:`full` reads a buffer's whole value; :func:`replicated_local` /
  :func:`replicated` cross between a replicated DTensor and a plain tensor
  for code that must see every row.
"""
from __future__ import annotations

import atexit

import torch

DTensor = None          # the DTensor class, once activate() ran
_replication = None     # the implicit_replication context kept entered


def activate():
    global DTensor, _replication
    if DTensor is not None:
        return
    from torch.distributed.tensor import DTensor as _DT
    from torch.distributed.tensor.experimental import implicit_replication
    _replication = implicit_replication()
    _replication.__enter__()
    # left at exit while torch is whole (a generator finalized at
    # interpreter teardown finds DTensor's dispatcher gone)
    atexit.register(_replication.__exit__, None, None, None)
    DTensor = _DT


def is_sharded(buf) -> bool:
    return DTensor is not None and isinstance(buf, DTensor)


def _reduced(buf):
    from torch.distributed.tensor import Replicate
    return buf.redistribute(buf.device_mesh,
                            [Replicate() if p.is_partial() else p
                             for p in buf.placements])


class _Settle(torch.autograd.Function):
    """Partial -> Replicate in the forward (an all-reduce); in the backward
    a partial gradient is reduced here too, and a replicated one passes as
    it is (the gradient of each rank's partial term is the whole
    gradient)."""

    @staticmethod
    def forward(ctx, buf):
        return _reduced(buf)

    @staticmethod
    def backward(ctx, g):
        if any(p.is_partial() for p in g.placements):
            g = _reduced(g)
        return g


def settle(buf):
    """``buf`` with every pending partial reduction done (Replicate)."""
    if not any(p.is_partial() for p in buf.placements):
        return buf
    return _Settle.apply(buf)


_gathered = {}      # id(Tensor) -> (weakref, mesh dims gathered at each use)


def gather_on_use(t, dims):
    """Mark parameter ``t`` (a sharded leaf) to be gathered on mesh
    dimensions ``dims`` wherever an op reads it (see the module doc)."""
    import weakref
    key = id(t)
    _gathered[key] = (weakref.ref(t, lambda _: _gathered.pop(key, None)),
                      tuple(dims))


def gather_inputs(inputs, arrays):
    """``arrays`` (the buffers of ``inputs``) with each marked parameter
    gathered on its dimensions; differentiable."""
    out = None
    for i, a in enumerate(inputs):
        e = _gathered.get(id(a))
        if e is None or e[0]() is not a or not is_sharded(arrays[i]):
            continue
        from torch.distributed.tensor import Replicate
        buf = arrays[i]
        pl = [Replicate() if d in e[1] else p
              for d, p in enumerate(buf.placements)]
        if out is None:
            out = list(arrays)
        out[i] = buf.redistribute(buf.device_mesh, pl)
    return arrays if out is None else tuple(out)


def rows_matmul(a, w):
    """``a @ w`` for a DTensor ``a`` [..., in] split on a leading dimension
    other than the first and a 2-D ``w`` [in, out], on each rank's shards:
    over a mesh dimension that splits ``a``'s rows, ``w`` must be
    replicated (its gradient there is a partial sum); over one that does
    not, ``a`` may be replicated against ``w`` split by columns (the
    output split the same way, ``a``'s gradient a partial sum) or split by
    its last dimension against ``w`` split by rows (the output a partial
    sum).  None for any other layout (the caller multiplies through
    DTensor)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    last = a.ndim - 1
    pl = a.placements
    if not any(p.is_shard() and 0 < p.dim % a.ndim < last for p in pl):
        return None
    dm = a.device_mesh
    if not is_sharded(w):
        w = replicated(w, dm)
    if w.device_mesh != dm or w.ndim != 2:
        return None
    out_pl, a_grad, w_grad = [], [], []
    for ap, wp in zip(pl, w.placements):
        if ap.is_partial() or wp.is_partial():
            return None
        if ap.is_shard() and ap.dim % a.ndim < last:        # split rows
            if not wp.is_replicate():
                return None
            out_pl.append(Shard(ap.dim % a.ndim))
            a_grad.append(ap)
            w_grad.append(Partial())
        elif ap.is_shard():                                 # split features
            if not (wp.is_shard() and wp.dim == 0):
                return None
            out_pl.append(Partial())
            a_grad.append(ap)
            w_grad.append(wp)
        elif wp.is_shard() and wp.dim == 1:                 # column-parallel
            out_pl.append(Shard(last))
            a_grad.append(Partial())
            w_grad.append(wp)
        elif wp.is_replicate():
            out_pl.append(Replicate())
            a_grad.append(Replicate())
            w_grad.append(Replicate())
        else:
            return None
    out = torch.matmul(a.to_local(grad_placements=a_grad),
                       w.to_local(grad_placements=w_grad))
    return DTensor.from_local(out, dm, out_pl, run_check=False)


def full(buf):
    """The whole value of ``buf`` on every rank (a collective: every rank
    of its mesh must call it)."""
    return buf.full_tensor() if is_sharded(buf) else buf


def replicated_local(buf):
    """``(plain tensor, mesh)``: a sharded ``buf``'s whole value as this
    rank's plain tensor (gathered if it is sharded), differentiable, and its
    mesh; ``(buf, None)`` for a plain one.  For code that must see every
    row (a cumulative sum over tokens) and computes the same on each rank."""
    if not is_sharded(buf):
        return buf, None
    from torch.distributed.tensor import Replicate
    dm = buf.device_mesh
    return buf.redistribute(dm, [Replicate()] * dm.ndim).to_local(), dm


def replicated(t, mesh):
    """``t`` (the same on every rank of ``mesh``) as a replicated DTensor;
    ``t`` itself when ``mesh`` is None."""
    if mesh is None:
        return t
    from torch.distributed.tensor import DTensor, Replicate
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)
