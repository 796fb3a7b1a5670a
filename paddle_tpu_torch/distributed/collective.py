"""Explicit collective API: counterpart of ``paddle_tpu/distributed/collective.py``
(reference: python/paddle/distributed/communication/ + ProcessGroup contract
phi/core/distributed/collective/process_group.h:130).

One process is one rank.  A :class:`Group` is a ``torch.distributed``
process group over its ranks: ``new_group`` / ``split_group`` call
``torch.distributed.new_group``, which every rank of the job must call for
every group, in one order (what the reference's ``new_group`` also asks of a
multi-process job).  Without a process group (one process) a Group has no
backing group and every collective is the identity of world size 1.

The tensor collectives take port Tensors (or torch tensors) and work as
Paddle's do: in place on the Tensor (a Tensor is rebound to the result),
``all_gather`` / ``all_to_all`` appending to the list they are given.
``all_reduce_grads`` averages gradients in place, bucketed by dtype.  The
``mesh_*`` functions are the reference's in-mesh helpers, over the hybrid
topology's group of the named axis and differentiable
(``torch.distributed.nn.functional``).  Each eager collective counts its
calls and payload bytes by kind into ``observability`` (:func:`_metered`).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..core.tensor import Tensor
from ..core.dispatch import unwrap
from .. import observability as _obs
from .env import get_rank, get_world_size


class ReduceOp:
    SUM = "sum"
    MAX = "max"
    MIN = "min"
    PROD = "prod"
    AVG = "avg"


def _torch_op(op):
    import torch.distributed as dist
    return {ReduceOp.SUM: dist.ReduceOp.SUM, ReduceOp.MAX: dist.ReduceOp.MAX,
            ReduceOp.MIN: dist.ReduceOp.MIN, ReduceOp.PROD: dist.ReduceOp.PRODUCT,
            ReduceOp.AVG: dist.ReduceOp.SUM}[op]


def _dist_up():
    import torch.distributed as dist
    return dist.is_available() and dist.is_initialized()


class Group:
    """reference: communication/group.py Group, over a torch process group
    (``pg``; None in a single process)."""

    _next_id = 0

    def __init__(self, ranks, name=None, pg=None):
        self.ranks = list(ranks)
        self.id = Group._next_id
        Group._next_id += 1
        self.name = name or f"group_{self.id}"
        self.pg = pg

    @property
    def nranks(self):
        return len(self.ranks)

    @property
    def world_size(self):
        return len(self.ranks)

    def get_rank(self):
        r = get_rank()
        return self.ranks.index(r) if r in self.ranks else -1

    def get_world_size(self):
        return len(self.ranks)

    @property
    def rank(self):
        return self.get_rank()

    @property
    def process_group(self):
        return self.pg

    def get_group_rank(self, global_rank):
        return self.ranks.index(global_rank) if global_rank in self.ranks else -1

    def __repr__(self):
        return f"Group(id={self.id}, ranks={self.ranks})"


_groups: dict[int, Group] = {}
_global_group: Group | None = None


def _get_global_group() -> Group:
    global _global_group
    if _global_group is None:
        import torch.distributed as dist
        pg = dist.group.WORLD if _dist_up() else None
        _global_group = Group(list(range(get_world_size())), name="global",
                              pg=pg)
        _groups[_global_group.id] = _global_group
    return _global_group


def new_group(ranks=None, backend=None, timeout=None):
    """A Group over ``ranks`` (all ranks by default).  Every rank calls it
    for every group, in the same order."""
    ranks = list(ranks) if ranks is not None else list(range(get_world_size()))
    pg = None
    if _dist_up():
        import torch.distributed as dist
        kw = {} if timeout is None else {"timeout": timeout}
        pg = dist.new_group(ranks, backend=backend, **kw)
    g = Group(ranks, pg=pg)
    _groups[g.id] = g
    return g


def split_group(parent=None, split_sizes=None):
    parent = parent or _get_global_group()
    out = []
    start = 0
    for s in split_sizes:
        out.append(new_group(parent.ranks[start:start + s]))
        start += s
    return out


def get_group(gid=0):
    return _groups.get(gid, _get_global_group())


def is_available():
    return True


def _pg(group):
    """(torch process group or None, world size) of ``group``."""
    g = group or _get_global_group()
    return g.pg, g.get_world_size()


def _buf(tensor):
    """A contiguous detached torch tensor holding ``tensor``'s value, and
    whether it is ``tensor``'s own storage (else the caller rebinds)."""
    b = unwrap(tensor) if isinstance(tensor, Tensor) else tensor
    own = not isinstance(tensor, Tensor) or (
        not b.requires_grad and b.is_contiguous())
    return (b.detach() if own else b.detach().contiguous().clone()), own


def _store(tensor, value, own):
    if isinstance(tensor, Tensor) and not own:
        tensor._data = value
    return tensor


def all_reduce(tensor, op=ReduceOp.SUM, group=None, sync_op=True):
    """In place: every rank's value reduced by ``op`` (AVG divides the sum
    by the group's size)."""
    pg, n = _pg(group)
    if n <= 1 or pg is None:
        return tensor
    import torch.distributed as dist
    b, own = _buf(tensor)
    with torch.no_grad():
        dist.all_reduce(b, op=_torch_op(op), group=pg)
        if op == ReduceOp.AVG:
            b.div_(n)
    return _store(tensor, b, own)


def all_gather(tensor_list, tensor, group=None, sync_op=True):
    pg, n = _pg(group)
    if n <= 1 or pg is None:
        tensor_list.append(Tensor(unwrap(tensor).detach().clone()))
        return tensor_list
    import torch.distributed as dist
    b, _ = _buf(tensor)
    outs = [torch.empty_like(b) for _ in range(n)]
    dist.all_gather(outs, b, group=pg)
    tensor_list.extend(Tensor(o) for o in outs)
    return tensor_list


def all_gather_object(object_list, obj, group=None):
    pg, n = _pg(group)
    if n <= 1 or pg is None:
        object_list.append(obj)
        return object_list
    import torch.distributed as dist
    out = [None] * n
    dist.all_gather_object(out, obj, group=pg)
    object_list.extend(out)
    return object_list


def broadcast(tensor, src=0, group=None, sync_op=True):
    pg, n = _pg(group)
    if n <= 1 or pg is None:
        return tensor
    import torch.distributed as dist
    b, own = _buf(tensor)
    dist.broadcast(b, src, group=pg)
    return _store(tensor, b, own)


def broadcast_object_list(object_list, src=0, group=None):
    pg, n = _pg(group)
    if n <= 1 or pg is None:
        return object_list
    import torch.distributed as dist
    dist.broadcast_object_list(object_list, src, group=pg)
    return object_list


def reduce(tensor, dst=0, op=ReduceOp.SUM, group=None, sync_op=True):
    """``dst`` receives the reduction; what the other ranks' tensors hold
    afterwards is undefined, as in torch and Paddle."""
    pg, n = _pg(group)
    if n <= 1 or pg is None:
        return tensor
    import torch.distributed as dist
    b, own = _buf(tensor)
    dist.reduce(b, dst, op=_torch_op(op), group=pg)
    if op == ReduceOp.AVG and get_rank() == dst:
        b.div_(n)
    return _store(tensor, b, own)


def scatter(tensor, tensor_list=None, src=0, group=None, sync_op=True):
    """Rank ``i`` of the group receives ``tensor_list[i]`` of ``src``."""
    pg, n = _pg(group)
    if n <= 1 or pg is None:
        if tensor_list:
            tensor._data = unwrap(tensor_list[0]).detach().clone()
        return tensor
    import torch.distributed as dist
    b, own = _buf(tensor)
    parts = [unwrap(t).detach().contiguous() for t in tensor_list] \
        if get_rank() == src else None
    dist.scatter(b, parts, src=src, group=pg)
    return _store(tensor, b, own)


def all_to_all(out_tensor_list, in_tensor_list, group=None, sync_op=True):
    """Rank ``i`` sends ``in_tensor_list[j]`` to rank ``j`` and appends what
    every rank sent it, in rank order, to ``out_tensor_list`` (through
    ``all_to_all_single`` over the stacked parts: gloo has no list form)."""
    pg, n = _pg(group)
    if n <= 1 or pg is None:
        out_tensor_list.extend(Tensor(unwrap(t).detach().clone())
                               for t in in_tensor_list)
        return out_tensor_list
    import torch.distributed as dist
    ins = [unwrap(t).detach().contiguous() for t in in_tensor_list]
    sizes = [int(t.numel()) for t in ins]
    flat = torch.cat([t.reshape(-1) for t in ins])
    # each peer's part sizes, so parts of different shapes round-trip
    shapes = [None] * n
    dist.all_gather_object(shapes, [tuple(t.shape) for t in ins], group=pg)
    me = get_rank(group) if group is not None else get_rank()
    recv_shapes = [shapes[r][me] for r in range(n)]
    recv_sizes = [int(np.prod(s)) for s in recv_shapes]
    out = flat.new_empty(sum(recv_sizes))
    dist.all_to_all_single(out, flat, recv_sizes, sizes, group=pg)
    for part, shp in zip(out.split(recv_sizes), recv_shapes):
        out_tensor_list.append(Tensor(part.reshape(shp).clone()))
    return out_tensor_list


def reduce_scatter(tensor, tensor_list, op=ReduceOp.SUM, group=None,
                   sync_op=True):
    """Rank ``i`` receives the reduction of every rank's ``tensor_list[i]``."""
    pg, n = _pg(group)
    if n <= 1 or pg is None:
        acc = unwrap(tensor_list[0])
        for t in tensor_list[1:]:
            acc = acc + unwrap(t)
        tensor._data = acc.detach().clone()
        return tensor
    import torch.distributed as dist
    b, own = _buf(tensor)
    flat = torch.cat([unwrap(t).detach().reshape(-1) for t in tensor_list])
    out = b.reshape(-1)
    dist.reduce_scatter_tensor(out, flat, op=_torch_op(op), group=pg)
    if op == ReduceOp.AVG:
        out.div_(n)
    return _store(tensor, out.reshape(b.shape), own)


_local_p2p: dict = {}


def send(tensor, dst=0, group=None, sync_op=True):
    """Point to point over the process group (reference: send over NCCL).
    A send to oneself in a single process queues the value for ``recv``."""
    me = get_rank()
    if dst == me and not _dist_up():       # self-send loopback
        _local_p2p.setdefault(("loop", me), []).append(
            unwrap(tensor).detach().clone())
        return tensor
    import torch.distributed as dist
    b, _ = _buf(tensor)
    dist.send(b, dst, group=_pg(group)[0])
    return tensor


def recv(tensor, src=0, group=None, sync_op=True):
    me = get_rank()
    if src == me and not _dist_up():       # self-recv loopback
        q = _local_p2p.get(("loop", me), [])
        if not q:
            raise RuntimeError("recv from self with nothing sent")
        tensor._data = q.pop(0)
        return tensor
    import torch.distributed as dist
    b, own = _buf(tensor)
    dist.recv(b, src, group=_pg(group)[0])
    return _store(tensor, b, own)


def barrier(group=None):
    pg, n = _pg(group)
    if n > 1 and pg is not None:
        import torch.distributed as dist
        dist.barrier(group=pg)


def all_reduce_grads(parameters, group=None, bucket_mb=25):
    """Average every gradient over ``group`` in place: gradients are
    flattened into buckets of up to ``bucket_mb`` MB a dtype, one
    all-reduce a bucket (the reference's EagerReducer buckets the same
    way, reducer.h:88)."""
    pg, n = _pg(group)
    if n <= 1 or pg is None:
        return
    import torch.distributed as dist
    grads = [unwrap(p.grad) for p in parameters if p.grad is not None]
    buckets, cur, size = [], [], 0
    limit = int(bucket_mb * 2 ** 20)
    for g in sorted(grads, key=lambda g: str(g.dtype)):
        if cur and (g.dtype != cur[0].dtype
                    or size + g.numel() * g.element_size() > limit):
            buckets.append(cur)
            cur, size = [], 0
        cur.append(g)
        size += g.numel() * g.element_size()
    if cur:
        buckets.append(cur)
    with torch.no_grad():
        for b in buckets:
            flat = torch.cat([g.reshape(-1) for g in b])
            _obs.record_collective("all_reduce", payload=flat, traced=False)
            dist.all_reduce(flat, group=pg)
            flat.div_(n)
            for g, part in zip(b, flat.split([g.numel() for g in b])):
                g.copy_(part.view_as(g))


# in-mesh collective helpers: each runs over the hybrid topology's group of
# the named axis and is differentiable; each meters itself.
def _axis_group(axis_name):
    from .fleet.topology import get_hybrid_communicate_group
    return get_hybrid_communicate_group().axis_group(axis_name)


def mesh_all_reduce(x, axis_name, op="sum"):
    from ..core.dispatch import apply_op
    import torch.distributed.nn.functional as dnn
    _obs.record_collective("mesh_all_reduce", payload=unwrap(x), traced=False)
    g = _axis_group(axis_name)
    if g.pg is None or g.nranks == 1:
        return x
    if op == "avg":
        return apply_op("mesh_all_reduce",
                        lambda a: dnn.all_reduce(a, group=g.pg) / g.nranks, x)
    if op not in ("sum", "max", "min"):
        raise ValueError(op)
    return apply_op("mesh_all_reduce",
                    lambda a: dnn.all_reduce(a, op=_torch_op(op), group=g.pg),
                    x)


def mesh_all_gather(x, axis_name, axis=0):
    from ..core.dispatch import apply_op
    import torch.distributed.nn.functional as dnn
    _obs.record_collective("mesh_all_gather", payload=unwrap(x), traced=False)
    g = _axis_group(axis_name)
    if g.pg is None or g.nranks == 1:
        return x
    return apply_op("mesh_all_gather",
                    lambda a: torch.cat(dnn.all_gather(a.contiguous(),
                                                       group=g.pg), dim=axis),
                    x)


def mesh_reduce_scatter(x, axis_name, axis=0):
    from ..core.dispatch import apply_op
    import torch.distributed.nn.functional as dnn
    _obs.record_collective("mesh_reduce_scatter", payload=unwrap(x),
                           traced=False)
    g = _axis_group(axis_name)
    if g.pg is None or g.nranks == 1:
        return x

    def f(a):
        parts = [p.contiguous() for p in a.chunk(g.nranks, dim=axis)]
        out = torch.empty_like(parts[0])
        return dnn.reduce_scatter(out, parts, group=g.pg)
    return apply_op("mesh_reduce_scatter", f, x)


def mesh_all_to_all(x, axis_name, split_axis, concat_axis):
    from ..core.dispatch import apply_op
    import torch.distributed.nn.functional as dnn
    _obs.record_collective("mesh_all_to_all", payload=unwrap(x), traced=False)
    g = _axis_group(axis_name)
    if g.pg is None or g.nranks == 1:
        return x

    def f(a):
        parts = [p.contiguous() for p in a.chunk(g.nranks, dim=split_axis)]
        outs = [torch.empty_like(p) for p in parts]
        outs = dnn.all_to_all(outs, parts, group=g.pg)
        return torch.cat(outs, dim=concat_axis)
    return apply_op("mesh_all_to_all", f, x)


def _exchange(sends, recvs, group):
    """Point-to-point transfers within ``group`` (a :class:`Group` with a
    process group): ``sends`` is ``[(tensor, dst)]``, ``recvs`` ``[(tensor,
    src)]`` with peers as indices in the group; every transfer completes
    before it returns.  Over NCCL they go in one ``batch_isend_irecv``;
    elsewhere each is posted alone (gloo and the ``staged`` backend post
    and return), sends first, and all are waited on together, so two ranks
    that send to each other before they receive cannot deadlock."""
    import torch.distributed as dist
    ops = [(dist.isend, t, group.ranks[p]) for t, p in sends]
    rops = [(dist.irecv, t, group.ranks[p]) for t, p in recvs]
    if not ops and not rops:
        return
    dev = (sends or recvs)[0][0].device
    if dev.type == "cuda" and "nccl" in str(dist.get_backend(group.pg)):
        works = dist.batch_isend_irecv([dist.P2POp(f, t, p, group=group.pg)
                                        for f, t, p in ops + rops])
    else:
        works = [f(t, p, group=group.pg) for f, t, p in ops + rops]
    for w in works:
        if w is not None:
            w.wait()


def _permute(a, g, perm):
    """``a`` sent along ``perm`` (indices in group ``g``); zeros where no
    one sends to this rank."""
    me = g.get_rank()
    a = a.contiguous()
    out = None
    sends, recvs = [], []
    for s, d in perm:
        if s == me and d == me:
            out = a.clone()
        elif s == me:
            sends.append((a, d))
        elif d == me:
            out = torch.empty_like(a)
            recvs.append((out, s))
    _exchange(sends, recvs, g)
    return torch.zeros_like(a) if out is None else out


class _PPermute(torch.autograd.Function):
    """``jax.lax.ppermute``: the forward sends along ``perm``; the backward
    sends the cotangent back along the inverse permutation (an index no
    one sent from gets zeros)."""

    @staticmethod
    def forward(ctx, a, g, perm):
        ctx.g, ctx.perm = g, perm
        return _permute(a.detach(), g, perm)

    @staticmethod
    def backward(ctx, gout):
        inv = tuple((d, s) for s, d in ctx.perm)
        return _permute(gout, ctx.g, inv), None, None


def mesh_ppermute(x, axis_name, perm):
    """Send to ``dst`` and receive from ``src`` for each ``(src, dst)`` pair of
    ``perm`` (indices on the axis); an index nobody sends to gets zeros, as
    ``jax.lax.ppermute``, and differentiable as it is."""
    from ..core.dispatch import apply_op
    _obs.record_collective("mesh_ppermute", payload=unwrap(x), traced=False)
    g = _axis_group(axis_name)
    if g.pg is None or g.nranks == 1:
        return x
    perm = tuple((int(s), int(d)) for s, d in perm)
    if isinstance(x, Tensor):
        return apply_op("mesh_ppermute", lambda a: _PPermute.apply(a, g, perm),
                        x)
    return _PPermute.apply(x, g, perm)


def _metered(fn):
    """Count invocation + payload bytes of an explicit eager collective in the
    observability registry (single bool check while telemetry is off)."""
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        if _obs.enabled():
            payload = next((unwrap(a) for a in args if isinstance(a, Tensor)),
                           None)
            _obs.record_collective(fn.__name__, payload=payload, traced=False)
        return fn(*args, **kwargs)
    return wrapper


all_reduce = _metered(all_reduce)
all_gather = _metered(all_gather)
broadcast = _metered(broadcast)
reduce = _metered(reduce)
scatter = _metered(scatter)
all_to_all = _metered(all_to_all)
reduce_scatter = _metered(reduce_scatter)
send = _metered(send)
recv = _metered(recv)
barrier = _metered(barrier)


# ---- API-parity wrappers (reference: distributed/communication/*) -----------
alltoall = all_to_all      # reference exposes both names


def all_to_all_single(out_tensor, in_tensor, out_split_sizes=None,
                      in_split_sizes=None, group=None, sync_op=True):
    """reference: communication/all_to_all.py alltoall_single — a single
    tensor split row-wise across ranks."""
    pg, n = _pg(group)
    if n <= 1 or pg is None:
        out_tensor._data = unwrap(in_tensor).detach().clone()
        return out_tensor
    import torch.distributed as dist
    src = unwrap(in_tensor).detach().contiguous()
    rows = list(out_split_sizes) if out_split_sizes else None
    if rows is None:
        out = torch.empty_like(src)
    else:
        out = src.new_empty((sum(rows),) + tuple(src.shape[1:]))
    dist.all_to_all_single(out, src, rows,
                           list(in_split_sizes) if in_split_sizes else None,
                           group=pg)
    out_tensor._data = out
    return out_tensor


all_to_all_single = _metered(all_to_all_single)


def gather(tensor, gather_list=None, dst=0, group=None, sync_op=True):
    """reference: communication/gather.py — all ranks contribute, dst gets
    the list."""
    out = []
    all_gather(out, tensor, group=group)
    if gather_list is not None and get_rank() == dst:
        gather_list.extend(out)
    return gather_list if get_rank() == dst else None


def gather_object(obj, object_list=None, dst=0, group=None):
    out = []
    all_gather_object(out, obj, group=group)
    if object_list is not None and get_rank() == dst:
        object_list.extend(out)
    return object_list if get_rank() == dst else None


def scatter_object_list(out_object_list, in_object_list=None, src=0,
                        group=None):
    """reference: communication/scatter.py scatter_object_list."""
    pg, n = _pg(group)
    if n <= 1 or pg is None:
        out_object_list.append(in_object_list[0] if in_object_list else None)
        return out_object_list
    gathered = []
    all_gather_object(gathered, in_object_list if get_rank() == src else
                      None, group=group)
    src_list = gathered[(group or _get_global_group()).get_group_rank(src)]
    out_object_list.append(src_list[(group or _get_global_group()).get_rank()])
    return out_object_list


class _Work:
    """A handle on a point-to-point transfer (reference: async
    Task.wait() contract)."""

    def __init__(self, result=None, work=None):
        self._result = result
        self._work = work

    def wait(self, timeout=None):
        if self._work is not None:
            self._work.wait()
        return True

    def is_completed(self):
        return self._work is None or self._work.is_completed()


def isend(tensor, dst=0, group=None):
    me = get_rank()
    if dst == me and not _dist_up():
        send(tensor, dst=dst, group=group)
        return _Work(tensor)
    import torch.distributed as dist
    b, _ = _buf(tensor)
    return _Work(tensor, dist.isend(b, dst, group=_pg(group)[0]))


def irecv(tensor, src=0, group=None):
    me = get_rank()
    if src == me and not _dist_up():
        recv(tensor, src=src, group=group)
        return _Work(tensor)
    import torch.distributed as dist
    b, own = _buf(tensor)
    w = dist.irecv(b, src, group=_pg(group)[0])
    return _RecvWork(tensor, w, b, own)


class _RecvWork(_Work):
    def __init__(self, tensor, work, b, own):
        super().__init__(tensor, work)
        self._b, self._own = b, own

    def wait(self, timeout=None):
        self._work.wait()
        _store(self._result, self._b, self._own)
        return True


def wait(tensor, group=None, use_calc_stream=True):
    """reference: communication/wait.py — a device sync on the tensor."""
    b = unwrap(tensor)
    if b.is_cuda:
        torch.cuda.current_stream(b.device).synchronize()
    return tensor


class P2POp:
    """reference: communication/batch_isend_irecv.py P2POp."""

    def __init__(self, op, tensor, peer, group=None):
        self.op = op
        self.tensor = tensor
        self.peer = peer
        self.group = group


def batch_isend_irecv(p2p_op_list):
    """reference: batch_isend_irecv — every send and receive of the list
    posted together (torch's ``batch_isend_irecv``); returns their works."""
    if not _dist_up():
        sends = [p for p in p2p_op_list if p.op in (isend, send, "isend")]
        recvs = [p for p in p2p_op_list if p not in sends]
        return [isend(p.tensor, dst=p.peer, group=p.group) for p in sends] + \
            [irecv(p.tensor, src=p.peer, group=p.group) for p in recvs]
    import torch.distributed as dist
    ops, works = [], []
    for p in p2p_op_list:
        is_send = p.op in (isend, send, "isend")
        b, own = _buf(p.tensor)
        ops.append(dist.P2POp(dist.isend if is_send else dist.irecv, b,
                              p.peer, group=_pg(p.group)[0]))
        works.append((p.tensor, b, own, is_send))
    out = []
    for (t, b, own, is_send), w in zip(works, dist.batch_isend_irecv(ops)):
        out.append(_Work(t, w) if is_send else _RecvWork(t, w, b, own))
    return out


def destroy_process_group(group=None):
    """reference: communication/group.py destroy_process_group; with no
    group, the job's process group goes too."""
    global _global_group
    if group is None:
        _groups.clear()
        _global_group = None
        if _dist_up():
            import torch.distributed as dist
            dist.destroy_process_group()
        from . import env
        env._initialized = False
    else:
        _groups.pop(getattr(group, "id", None), None)
