"""The bodies the distributed tests run on each rank (``_torch_dist.run``):
plain port code on the CPU over gloo, importing neither JAX nor the JAX
package.  Each takes ``(rank, world, *args)`` and returns picklable results
(numpy arrays, floats)."""
import numpy as np

NAMES = ["dp", "pp", "sharding", "sep", "mp", "ep"]


def _hybrid(dims):
    """fleet.init with the hybrid degrees ``dims`` (a dict of *_degree)."""
    from paddle_tpu_torch.distributed import fleet
    strategy = fleet.DistributedStrategy()
    hc = {f"{n}_degree": 1 for n in NAMES}
    hc.update(dims)
    strategy.hybrid_configs = hc
    fleet.init(is_collective=True, strategy=strategy)
    return fleet.get_hybrid_communicate_group()


def _np(t):
    return np.asarray(t.numpy())


def grad_norm(params):
    """The global gradient norm (every rank calls it: sharded gradients
    reduce over their shards)."""
    import torch
    from paddle_tpu_torch.core import sharding
    sq = None
    for p in params:
        if p.grad is not None:
            s = torch.sum(torch.square(p.grad._buf.float()))
            sq = s if sq is None else sq + s
    return float(sharding.full(sq)) ** 0.5


# ------------------------------------------------------------- collectives
def collectives(rank, world):
    """Every eager collective once; rank r's input is r-dependent."""
    import paddle_tpu_torch as tp
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch import observability as obs
    obs.enable()
    out = {}

    def t(a):
        return tp.to_tensor(np.asarray(a, np.float32))
    base = np.arange(6, dtype=np.float32).reshape(2, 3)
    for op in ("sum", "max", "min", "prod", "avg"):
        x = t(base + rank + 1)
        dist.all_reduce(x, op=op)
        out[f"all_reduce_{op}"] = _np(x)
    lst = []
    dist.all_gather(lst, t(base * (rank + 1)))
    out["all_gather"] = np.stack([_np(v) for v in lst])
    objs = []
    dist.all_gather_object(objs, {"rank": rank, "sq": rank * rank})
    out["all_gather_object"] = objs
    x = t(base + rank)
    dist.broadcast(x, src=1)
    out["broadcast"] = _np(x)
    ol = [{"from": rank}] if rank == 0 else [None]
    dist.broadcast_object_list(ol, src=0)
    out["broadcast_object_list"] = ol
    x = t(base + rank)
    dist.reduce(x, dst=0)
    out["reduce"] = _np(x)
    x = t(np.zeros((2, 3)))
    parts = [t(base * (i + 10)) for i in range(world)] if rank == 0 else None
    dist.scatter(x, parts, src=0)
    out["scatter"] = _np(x)
    outs = []
    dist.all_to_all(outs, [t(np.full((i + 1, 2), 10 * rank + i))
                           for i in range(world)])
    out["all_to_all"] = [_np(v) for v in outs]
    y = t(np.arange(world * 2, dtype=np.float32).reshape(world, 2)
          + 100 * rank)
    o = t(np.zeros((world, 2)))
    dist.all_to_all_single(o, y)
    out["all_to_all_single"] = _np(o)
    x = t(np.zeros(3))
    dist.reduce_scatter(x, [t(np.full(3, rank * 10 + i)) for i in range(world)])
    out["reduce_scatter"] = _np(x)
    g = []
    res = dist.gather(t(base + rank), g, dst=0)
    out["gather"] = None if res is None else np.stack([_np(v) for v in g])
    go = []
    out["gather_object"] = dist.gather_object(rank * 3, go, dst=0)
    so = []
    dist.scatter_object_list(so, [f"to{i}" for i in range(world)] if rank == 0
                             else None, src=0)
    out["scatter_object_list"] = so
    # point to point: a ring, blocking, batched and non-blocking
    nxt, prv = (rank + 1) % world, (rank - 1) % world
    r = t(np.zeros(3))
    if rank % 2 == 0:
        dist.send(t(np.full(3, rank)), dst=nxt)
        dist.recv(r, src=prv)
    else:
        dist.recv(r, src=prv)
        dist.send(t(np.full(3, rank)), dst=nxt)
    out["send_recv"] = _np(r)
    r2 = t(np.zeros(3))
    works = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, t(np.full(3, -rank)), nxt),
        dist.P2POp(dist.irecv, r2, prv)])
    for w in works:
        w.wait()
    out["batch_isend_irecv"] = _np(r2)
    r3 = t(np.zeros(3))
    ws = dist.isend(t(np.full(3, rank + 0.5)), dst=nxt)
    wr = dist.irecv(r3, src=prv)
    ws.wait()
    wr.wait()
    out["isend_irecv"] = _np(r3)
    dist.barrier()
    # a sub-group of the even ranks (every rank makes every group)
    evens = dist.new_group([r for r in range(world) if r % 2 == 0])
    x = t(np.full(2, rank + 1.0))
    if rank % 2 == 0:
        dist.all_reduce(x, group=evens)
    out["subgroup_all_reduce"] = _np(x)
    out["subgroup_rank"] = evens.get_rank()
    halves = dist.split_group(split_sizes=[world // 2, world - world // 2])
    out["split_group"] = [h.ranks for h in halves]
    # all_reduce_grads averages gradients in place
    p = tp.Parameter(np.zeros(4, np.float32))
    p.grad = t(np.full(4, rank + 1.0))
    dist.all_reduce_grads([p])
    out["all_reduce_grads"] = _np(p.grad)
    out["metered"] = obs.snapshot(prefix="collective_")
    obs.disable()
    return out


def mesh_helpers(rank, world):
    """The ``mesh_*`` functions over the 'mp' axis (all ranks on mp),
    values and gradients."""
    import paddle_tpu_torch as tp
    from paddle_tpu_torch.distributed import collective as c
    _hybrid({"mp_degree": world})
    out = {}
    base = np.arange(4 * world, dtype=np.float32).reshape(world, 4) + rank
    for name, fn in (("all_reduce", lambda x: c.mesh_all_reduce(x, "mp")),
                     ("all_reduce_max",
                      lambda x: c.mesh_all_reduce(x, "mp", "max")),
                     ("all_gather", lambda x: c.mesh_all_gather(x, "mp", 0)),
                     ("reduce_scatter",
                      lambda x: c.mesh_reduce_scatter(x, "mp", 0)),
                     ("all_to_all",
                      lambda x: c.mesh_all_to_all(x, "mp", 0, 1))):
        x = tp.to_tensor(base, stop_gradient=False)
        y = fn(x)
        (y * (rank + 1)).sum().backward()
        out[name] = (_np(y), _np(x.grad))
    perm = [(i, (i + 1) % world) for i in range(world)]
    out["ppermute"] = _np(c.mesh_ppermute(tp.to_tensor(base), "mp", perm))
    # a step that issues a collective under to_static: on the CPU the body
    # runs every call (nothing is captured), with its collectives
    from paddle_tpu_torch.jit import to_static
    step = to_static(lambda x: c.mesh_all_reduce(x * 2, "mp"))
    out["static"] = [_np(step(tp.to_tensor(base))) for _ in range(3)]
    return out


# -------------------------------------------------------------- TP layers
def tp_layers(rank, world, w, x, labels):
    """ColumnParallelLinear, RowParallelLinear, VocabParallelEmbedding and
    ParallelCrossEntropy at mp = world with the given weights: outputs and
    gradients (gathered), on every rank."""
    import paddle_tpu_torch as tp
    from paddle_tpu_torch.parallel import (ColumnParallelLinear,
                                           RowParallelLinear,
                                           VocabParallelEmbedding,
                                           ParallelCrossEntropy)
    from paddle_tpu_torch.distributed import get_placements
    _hybrid({"mp_degree": world})
    out = {}
    col = ColumnParallelLinear(16, 32, gather_output=False)
    row = RowParallelLinear(32, 16, input_is_parallel=True)
    gcol = ColumnParallelLinear(16, 32, gather_output=True)
    for layer, pre in ((col, "col"), (row, "row"), (gcol, "col")):
        layer.set_state_dict({"weight": tp.to_tensor(w[pre + "_w"]),
                              "bias": tp.to_tensor(w[pre + "_b"])})
    out["placements"] = {"col_w": str(get_placements(col.weight)),
                         "col_b": str(get_placements(col.bias)),
                         "row_w": str(get_placements(row.weight))}
    xt = tp.to_tensor(x, stop_gradient=False)
    y = row(col(xt))
    (y * y).sum().backward()
    out["col_row"] = _np(y)
    out["grads"] = {n: _np(p.grad) for n, p in
                    (("col_w", col.weight), ("col_b", col.bias),
                     ("row_w", row.weight), ("row_b", row.bias), ("x", xt))}
    out["gathered"] = _np(gcol(tp.to_tensor(x)))
    emb = VocabParallelEmbedding(64, 16)
    emb.set_state_dict({"weight": tp.to_tensor(w["emb"])})
    ids = tp.to_tensor(np.array([[0, 13, 63, 40], [31, 32, 33, 1]], np.int64))
    e = emb(ids)
    (e * e).sum().backward()
    out["embedding"] = (_np(e), _np(emb.weight.grad))
    pce = ParallelCrossEntropy()
    lg = tp.to_tensor(w["logits"], stop_gradient=False)
    loss = pce(lg, tp.to_tensor(labels))
    loss.sum().backward()
    out["pce"] = (_np(loss), _np(lg.grad))
    return out


# -------------------------------------------------------------------- MoE
def moe_layer(rank, world, dims, state, x):
    """A MoELayer under ``dims`` with the given weights: output, aux and
    gradients; the experts' placements."""
    import paddle_tpu_torch as tp
    from paddle_tpu_torch.parallel import MoELayer
    from paddle_tpu_torch.distributed import get_placements
    _hybrid(dims)
    moe = MoELayer(d_model=16, num_experts=4, d_hidden=32,
                   capacity_factor=2.0, top_k=2)
    moe.set_state_dict({k: tp.to_tensor(v) for k, v in state.items()})
    xt = tp.to_tensor(x, stop_gradient=False)
    out = moe(xt)
    (out.sum() + moe.aux_loss * 0.01).backward()
    return {"out": _np(out), "aux": float(moe.aux_loss),
            "grads": {n: _np(p.grad) for n, p in moe.named_parameters()},
            "x_grad": _np(xt.grad),
            "placements": {n: str(get_placements(p))
                           for n, p in moe.named_parameters()}}


# ---------------------------------------------------------------- sharding
def sharding_stages(rank, world, state, xs, ys, steps):
    """Each ZeRO stage on a 2-layer MLP over the 'sharding' axis, AdamW:
    losses and the final weights; the rows of each moment this rank keeps;
    which parameters are sharded."""
    import paddle_tpu_torch as tp
    import paddle_tpu_torch.nn as nn
    from paddle_tpu_torch.distributed.sharding import group_sharded_parallel
    from paddle_tpu_torch.parallel import (GroupShardedStage2,
                                           GroupShardedStage3,
                                           GroupShardedOptimizerStage2,
                                           DygraphShardingOptimizer)
    hcg = _hybrid({"sharding_degree": world})
    out = {}
    for kind in ("os", "os_g", "p_g_os", "stage2", "stage3", "dygraph",
                 "opt_stage2"):
        model = nn.Sequential(nn.Linear(8, 16), nn.ReLU(), nn.Linear(16, 8))
        model.set_state_dict({k: tp.to_tensor(v) for k, v in state.items()})
        opt = tp.optimizer.AdamW(learning_rate=1e-2,
                                 parameters=model.parameters())
        if kind in ("os", "os_g", "p_g_os"):
            model, opt = group_sharded_parallel(model, opt, level=kind)
        elif kind == "stage2":
            model = GroupShardedStage2(model, opt)
        elif kind == "stage3":
            model = GroupShardedStage3(model, opt)
        elif kind == "dygraph":
            opt = DygraphShardingOptimizer(opt, hcg)
        else:
            opt = GroupShardedOptimizerStage2(params=model.parameters(),
                                              optim=opt)
        losses = []
        for _ in range(steps):
            loss = ((model(tp.to_tensor(xs)) - tp.to_tensor(ys)) ** 2).mean()
            loss.backward()
            opt.step()
            opt.clear_grad()
            losses.append(float(loss))
        inner = getattr(opt, "_inner_opt", opt)
        m1 = inner._accumulators["moment1"]
        out[kind] = {
            "losses": losses,
            "weights": {k: _np(v) for k, v in model.state_dict().items()},
            "state_rows": sorted(int(t._buf.shape[0]) for t in m1.values()),
            "params_sharded": [p.is_dist() for p in model.parameters()]}
    return out


# ------------------------------------------------------------------- fleet
def fleet_dp(rank, world, state, x, y):
    """fleet's distributed_model / distributed_optimizer at dp = world on
    each rank's slice of the batch, DataParallel's own reduction,
    SyncBatchNorm and the sampler's default ranks."""
    import paddle_tpu_torch as tp
    import paddle_tpu_torch.nn as nn
    from paddle_tpu_torch.distributed import fleet, DataParallel
    from paddle_tpu_torch import io
    _hybrid({"dp_degree": world})
    out = {}
    model = nn.Linear(8, 4)
    model.set_state_dict({k: tp.to_tensor(v) for k, v in state.items()})
    dp = fleet.distributed_model(model)
    out["wrapper"] = type(dp).__name__
    opt = fleet.distributed_optimizer(
        tp.optimizer.SGD(learning_rate=0.1, parameters=dp.parameters()))
    n = x.shape[0] // world
    xs, ys = x[rank * n:(rank + 1) * n], y[rank * n:(rank + 1) * n]
    loss = ((dp(tp.to_tensor(xs)) - tp.to_tensor(ys)) ** 2).mean()
    loss.backward()
    opt.step()
    opt.clear_grad()
    out["dp_weight"] = _np(model.weight)
    m2 = nn.Linear(8, 4)
    m2.set_state_dict({k: tp.to_tensor(v) for k, v in state.items()})
    d2 = DataParallel(m2)
    ((d2(tp.to_tensor(xs)) - tp.to_tensor(ys)) ** 2).mean().backward()
    d2.apply_collective_grads()
    out["apply_collective_grads"] = _np(m2.weight.grad)
    bn = nn.SyncBatchNorm(3)
    bn.train()
    xb = tp.to_tensor(x[rank * n:(rank + 1) * n, :3].reshape(n, 3, 1, 1),
                      stop_gradient=False)
    ob = bn(xb)
    (ob * ob * tp.to_tensor(np.arange(1.0, 4.0, dtype=np.float32)
                            .reshape(1, 3, 1, 1))).sum().backward()
    out["sync_bn"] = (_np(ob), _np(xb.grad), _np(bn._mean), _np(bn._variance))
    s = io.DistributedBatchSampler(io.TensorDataset([np.zeros((10, 1))]), 2)
    out["sampler"] = (s.nranks, s.local_rank, list(s))
    return out


# ------------------------------------------------------------ hybrid Llama
def llama_train(rank, world, cfg_kw, dims, state, ids, steps=2, mode="dense",
                clip=None):
    """Train the port's Layer Llama for ``steps`` AdamW steps on a hybrid
    topology; returns (losses, grad norms, placements).  ``mode``: "dense"
    (the batch on dp, shard_llama on dp x mp), "moe" (experts on ep, the
    hidden dim on mp), "zero3" (group_sharded p_g_os), "none"."""
    import paddle_tpu_torch as tp
    import paddle_tpu_torch.nn as nn
    from paddle_tpu_torch.distributed import (Replicate, Shard, shard_tensor,
                                              get_placements)
    from paddle_tpu_torch.distributed.sharding import group_sharded_parallel
    from paddle_tpu_torch.models.llama import (LlamaConfig, LlamaForCausalLM,
                                               shard_llama)
    hcg = _hybrid(dims)
    mesh = hcg.get_mesh()
    model = LlamaForCausalLM(LlamaConfig.tiny(**cfg_kw))
    model.set_state_dict({k: tp.to_tensor(v) for k, v in state.items()})
    if mode == "dense":
        shard_llama(model, mesh, fsdp_axis="dp", mp_axis="mp")
    opt = tp.optimizer.AdamW(
        learning_rate=1e-3, parameters=model.parameters(),
        grad_clip=nn.ClipGradByGlobalNorm(clip) if clip else None)
    if mode == "zero3":
        model, opt = group_sharded_parallel(model, opt, level="p_g_os")
    x, y = tp.to_tensor(ids[:, :-1]), tp.to_tensor(ids[:, 1:])
    # ZeRO's ranks are data-parallel: the batch splits over dp and sharding
    place = [Shard(0), Replicate(), Shard(0)] if mode == "zero3" else \
        [Shard(0)]
    losses, norms = [], []
    for _ in range(steps):
        xs = shard_tensor(x, mesh, place)
        _, loss = model(xs, labels=y)
        loss.backward()
        norms.append(grad_norm(model.parameters()))
        opt.step()
        opt.clear_grad()
        losses.append(float(loss))
    placements = {n: str(get_placements(p))
                  for n, p in model.named_parameters()}
    return losses, norms, placements


def hybrid_parts(rank, world, runs):
    """Several ``llama_train`` runs in one process group."""
    return [llama_train(rank, world, *r) for r in runs]


def staged_cpu(rank, world):
    """The ``staged`` backend (``csrc/staged_backend.cpp``) registered for
    CPU tensors, as it is for CUDA ones on a shared card: eager
    collectives and DTensor redistributions over a group of it, and its
    counters."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import DTensor, Partial, Shard
    from paddle_tpu_torch.distributed import staged
    staged.register(devices=("cpu",))
    g = dist.new_group(list(range(world)), backend=staged.NAME)
    staged.load().reset_counts()
    out = {}
    t = torch.full((3,), float(rank + 1))
    dist.all_reduce(t, group=g)
    out["all_reduce"] = t.numpy()
    o = torch.empty(2 * world)
    dist.all_gather_into_tensor(o, torch.full((2,), float(rank)), group=g)
    out["all_gather"] = o.numpy()
    r = torch.empty(2)
    dist.reduce_scatter_tensor(r, torch.arange(2.0 * world) + rank, group=g)
    out["reduce_scatter"] = r.numpy()
    a = torch.empty(world)
    dist.all_to_all_single(a, torch.arange(float(world)) + 10 * rank, group=g)
    out["all_to_all"] = a.numpy()
    b = torch.full((2,), float(rank))
    dist.broadcast(b, 1, group=g)
    out["broadcast"] = b.numpy()
    dist.barrier(group=g)
    mesh = DeviceMesh.from_group(g, "cpu")
    x = torch.arange(8.0).reshape(4, 2) + rank
    out["S->R"] = DTensor.from_local(x, mesh, [Shard(0)]).full_tensor().numpy()
    out["P->S"] = DTensor.from_local(x, mesh, [Partial()]).redistribute(
        mesh, [Shard(0)]).to_local().numpy()
    out["counts"] = dict(staged.load().counts())
    return out


def auto_parallel_api(rank, world, a, b, w):
    """``shard_tensor`` / ``reshard`` / ``get_placements`` /
    ``unshard_dtensor`` / ``dtensor_from_fn`` / ``shard_layer`` /
    ``local_map`` on a 2 x 2 (dp, mp) mesh, as the reference's
    ``TestShardTensor`` runs them; fleet's wrapper at mp = 2."""
    import paddle_tpu_torch as tp
    from paddle_tpu_torch.distributed import (
        ProcessMesh, Replicate, Shard, Partial, shard_tensor, reshard,
        get_placements, get_process_mesh, unshard_dtensor, dtensor_from_fn,
        shard_layer, local_map, fleet)
    mesh = ProcessMesh(np.arange(4).reshape(2, 2), ["dp", "mp"])
    out = {}
    x = tp.to_tensor(a)
    dt = shard_tensor(x, mesh, [Shard(0), Shard(1)])
    out["is_dist"] = dt.is_dist()
    out["shape"] = dt.shape
    out["placements"] = [str(p) for p in get_placements(dt)]
    out["mesh"] = get_process_mesh(dt).dim_names
    out["local_shape"] = list(dt._buf.to_local().shape)
    out["roundtrip"] = _np(unshard_dtensor(dt))
    r = shard_tensor(x, mesh, [Replicate(), Replicate()])
    s0 = reshard(r, mesh, [Shard(0)])
    s1 = reshard(s0, mesh, [Shard(1)])
    back = reshard(s1, mesh, [Replicate()])
    out["reshard"] = [_np(t) for t in (s0, s1, back)]
    p = shard_tensor(x, mesh, [Partial()])
    out["partial"] = _np(reshard(p, mesh, [Replicate()]))
    da = shard_tensor(tp.to_tensor(a), mesh, [Shard(0)])
    db = shard_tensor(tp.to_tensor(b), mesh, [Replicate(), Shard(1)])
    out["matmul"] = _np(da @ db)
    wp = tp.Parameter(w)
    wp._data = shard_tensor(wp, mesh, [Shard(0)])._data
    xt = tp.to_tensor(a[:, :8])
    (xt @ wp).sum().backward()
    out["grad"] = _np(wp.grad)
    f = dtensor_from_fn(tp.ones, mesh, [Shard(0)], [4, 2])
    out["from_fn"] = (_np(f), [str(q) for q in get_placements(f)])
    lin = tp.nn.Linear(8, 4)
    shard_layer(lin, mesh)
    out["shard_layer"] = [p.is_dist() for p in lin.parameters()]
    doubled = local_map(lambda t: t * 2, out_placements=[[Shard(0)]],
                        in_placements=[[Shard(0)]], process_mesh=mesh)(x)
    out["local_map"] = (_np(doubled), [str(q) for q in
                                       get_placements(doubled)])
    strategy = fleet.DistributedStrategy()
    strategy.hybrid_configs = {"dp_degree": 2, "mp_degree": 2}
    fleet.init(is_collective=True, strategy=strategy)
    model = tp.nn.Linear(4, 4)
    tpw = fleet.distributed_model(model)
    out["tensor_parallel"] = (type(tpw).__name__, len(tpw.state_dict()),
                              len(tpw.parameters()))
    return out


# --------------------------------------------------- collectives of a step
class _CommBytes:
    """CommDebugMode's collective counts of a region, with the bytes each
    rank hands each kind (the first tensor argument of every c10d op)."""

    def __init__(self):
        from torch.distributed.tensor.debug import CommDebugMode
        from torch.utils._python_dispatch import TorchDispatchMode

        class _Bytes(TorchDispatchMode):
            def __init__(self, sink):
                super().__init__()
                self.sink = sink

            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                ns = func.namespace
                if ns in ("_c10d_functional", "c10d"):
                    t = args[0]
                    t = t[0] if isinstance(t, (list, tuple)) else t
                    kind = func._overloadpacket.__name__.rstrip("_")
                    self.sink.setdefault(kind, []).append(
                        int(t.numel() * t.element_size()))
                return func(*args, **(kwargs or {}))

        self.sizes = {}
        self.counter = CommDebugMode()
        self._bytes = _Bytes(self.sizes)

    def __enter__(self):
        self.counter.__enter__()
        self._bytes.__enter__()
        return self

    def __exit__(self, *exc):
        self._bytes.__exit__(*exc)
        self.counter.__exit__(*exc)

    def counts(self):
        """{kind: calls}, kinds named as ``sizes`` names them (the op
        without its namespace or trailing underscore)."""
        out = {}
        for k, v in self.counter.get_comm_counts().items():
            name = getattr(k, "__name__", str(k)).split(".")[-1].rstrip("_")
            out[name] = out.get(name, 0) + v
        return out


def llama_comms(rank, world, mode, state):
    """One tiny-Llama step under mp = world (``shard_llama``) or ZeRO-3 at
    sharding = world (the batch split over it): the collectives of the
    forward and of the backward by kind (CommDebugMode) and the bytes this
    rank hands each; the parameters' sizes."""
    import paddle_tpu_torch as tp
    from paddle_tpu_torch.distributed import Replicate, Shard, shard_tensor
    from paddle_tpu_torch.distributed.sharding import group_sharded_parallel
    from paddle_tpu_torch.models.llama import (LlamaConfig, LlamaForCausalLM,
                                               shard_llama)
    hcg = _hybrid({"mp_degree": world} if mode == "mp"
                  else {"sharding_degree": world})
    mesh = hcg.get_mesh()
    model = LlamaForCausalLM(LlamaConfig.tiny(num_key_value_heads=4))
    model.set_state_dict({k: tp.to_tensor(v) for k, v in state.items()})
    opt = tp.optimizer.AdamW(learning_rate=1e-3,
                             parameters=model.parameters())
    if mode == "mp":
        shard_llama(model, mesh, fsdp_axis="dp", mp_axis="mp")
        place = [Shard(0)]
    else:
        model, opt = group_sharded_parallel(model, opt, level="p_g_os")
        place = [Shard(0), Replicate(), Shard(0)]
    ids = np.random.RandomState(0).randint(0, 256, (4, 33)).astype(np.int64)
    x = shard_tensor(tp.to_tensor(ids[:, :-1]), mesh, place)
    y = tp.to_tensor(ids[:, 1:])
    out = {"params": [int(np.prod(p.shape)) for p in model.parameters()]}
    with _CommBytes() as fwd:
        _, loss = model(x, labels=y)
    with _CommBytes() as bwd:
        loss.backward()
    out["fwd"], out["bwd"] = (fwd.counts(), fwd.sizes), (bwd.counts(),
                                                         bwd.sizes)
    out["loss"] = float(loss)
    return out


def hybrid_comms(rank, world, state):
    return {mode: llama_comms(rank, world, mode, state)
            for mode in ("mp", "zero3")}


# -------------------------------------------------------------- pipelines
def _pp_norm(params, group, elsewhere=()):
    """The global gradient norm over the stages (each rank's own
    parameters, summed over the 'pp' group; a tied weight's copy on a later
    stage, ``elsewhere``, not counted twice)."""
    import torch
    import torch.distributed as dist
    sq = torch.zeros(())
    for p in params:
        if p.grad is not None and id(p) not in elsewhere:
            sq = sq + torch.sum(torch.square(p.grad._buf.float()))
    dist.all_reduce(sq, group=group.pg)
    return float(sq) ** 0.5


def _InfOnce(flag):
    """A loss scaler whose first unscale reports a non-finite gradient
    when ``flag`` is set (on one stage of a pipeline only)."""
    from paddle_tpu_torch.amp import GradScaler

    class _Scaler(GradScaler):
        calls = 0

        def unscale_(self, optimizer):
            super().unscale_(optimizer)
            if flag and self.calls == 0:
                self._found_inf = True
            self.calls += 1
    return _Scaler(init_loss_scaling=2.0 ** 10)


def pipeline_runs(rank, world, runs, part_c):
    """pp = world: each run trains ``LlamaForCausalLMPipe`` from the given
    state (the pipe's parameter names) under its schedule ("1F1B", "ZB-H1",
    "VPP", "FThenB") with AdamW, or, given ``clip``, with SGD and
    ``ClipGradByGlobalNorm(clip)``, and given ``scaler``, under a loss
    scaler that finds a non-finite gradient on the last stage alone at the
    first step, returning its losses, the global
    gradient norm of each step before the clip, the max in flight and the
    embedding weight at the end (a tied one's copy on the last stage too);
    then dryrun part C: the SPMD GPipe ``pipeline_forward`` over
    ``make_decoder_stage`` with the stacked weights given, its output and
    this rank's stage gradients."""
    import torch
    import paddle_tpu_torch as tp
    from paddle_tpu_torch.models.llama import (LlamaConfig,
                                               LlamaForCausalLMPipe,
                                               make_decoder_stage)
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.parallel import (PipelineParallel,
                                           PipelineParallelWithInterleave,
                                           ZeroBubblePipelineParallel,
                                           pipeline_forward)
    hcg = _hybrid({"pp_degree": world})
    group = hcg.get_pipe_parallel_group()
    out = {}
    for run in runs:
        mode = run["mode"]
        cfg = LlamaConfig.tiny(**run["cfg"])
        vpp = 2 if mode == "VPP" else None
        pipe = LlamaForCausalLMPipe(cfg, num_stages=world,
                                    num_virtual_pipeline_stages=vpp)
        pipe.set_state_dict({k: tp.to_tensor(v)
                             for k, v in run["state"].items()})

        class _S:
            pipeline_configs = {"accumulate_steps": run["n_micro"],
                                "schedule_mode": mode}
        cls = {"VPP": PipelineParallelWithInterleave,
               "ZB-H1": ZeroBubblePipelineParallel}.get(mode,
                                                        PipelineParallel)
        model = cls(pipe, strategy=_S())
        norms = []
        clip = run.get("clip")
        base = tp.optimizer.AdamW if clip is None else tp.optimizer.SGD
        scaler = _InfOnce(rank == world - 1) if run.get("scaler") else None

        class _Opt(base):
            def step(self):
                norms.append(_pp_norm(self._parameter_list, group,
                                      pipe._replicas))
                return super().step()
        opt = _Opt(learning_rate=run["lr"], parameters=model.parameters(),
                   grad_clip=None if clip is None
                   else ClipGradByGlobalNorm(clip))
        losses = [float(model.train_batch(
            (tp.to_tensor(b[:, :-1]), tp.to_tensor(b[:, 1:])), opt,
            scaler=scaler)) for b in run["batches"]]
        embed = pipe.state_dict().get("_layers_list.0.embed_tokens.weight")
        out[run["name"]] = {
            "losses": losses, "norms": norms,
            "in_flight": model.max_in_flight, "mode": model.schedule_mode,
            "w_deferred": getattr(model, "w_deferred_total", 0),
            "embed": None if embed is None else _np(embed)}
    stacked, xs, cfg_kw = part_c
    _, apply = make_decoder_stage(LlamaConfig.tiny(**cfg_kw))
    ws = {k: torch.tensor(v, requires_grad=True) for k, v in stacked.items()}
    y = pipeline_forward(apply, ws, torch.tensor(xs), axis_name="pp")
    (y ** 2).sum().backward()
    out["C"] = {"out": y.detach().numpy(),
                "grads": {k: v.grad[rank].numpy() for k, v in ws.items()},
                "others_zero": all(
                    bool((v.grad[s] == 0).all()) for v in ws.values()
                    for s in range(world) if s != rank)}
    return out


# ------------------------------------------------------ the 'sep' axis
def sequence_parallel_cases(rank, world, a):
    """sep = world: ring and Ulysses attention (causal and not) on q / k / v
    the same on every rank, their outputs and the gradients of
    sum(out * out); the ring with grouped K / V; Ulysses' head check;
    mesh_ppermute's value and gradient of sum(w * ppermute(x)) for three
    permutations (rank r's row of x and w); then mp = world: the
    sequence-parallel linear pair."""
    import paddle_tpu_torch as tp
    from paddle_tpu_torch.distributed import collective as c
    from paddle_tpu_torch.parallel import (ring_flash_attention,
                                           ulysses_attention)
    from paddle_tpu_torch.parallel.sequence_parallel import (
        ColumnSequenceParallelLinear, RowSequenceParallelLinear, scatter,
        all_gather)
    q, k, v, kq = a["q"], a["k"], a["v"], a["kq"]
    _hybrid({"sep_degree": world})
    out = {}

    def attn(fn, a, b, cc, causal):
        ts = [tp.to_tensor(t, stop_gradient=False) for t in (a, b, cc)]
        o = fn(*ts, causal=causal)
        (o * o).sum().backward()
        return _np(o), [_np(t.grad) for t in ts]

    for causal in (False, True):
        out[("ring", causal)] = attn(ring_flash_attention, q, k, v, causal)
        out[("ulysses", causal)] = attn(ulysses_attention, q, k, v, causal)
    out["ring_gqa"] = attn(ring_flash_attention, q, kq, kq, True)
    try:
        odd = tp.to_tensor(a["odd"])
        ulysses_attention(odd, odd, odd)
        out["divisible"] = None
    except ValueError as e:
        out["divisible"] = str(e)
    _hybrid({"mp_degree": world})
    perms = {"ring": [(i, (i + 1) % world) for i in range(world)],
             "partial": [(i, i + 1) for i in range(world - 1)],
             "shift2": [(i, (i + 2) % world) for i in range(world)]}
    for name, perm in perms.items():
        x = tp.to_tensor(a["perm_x"][rank], stop_gradient=False)
        y = c.mesh_ppermute(x, "mp", perm)
        (tp.to_tensor(a["perm_w"][rank]) * y).sum().backward()
        out[("ppermute", name)] = (_np(y), _np(x.grad))
    col = ColumnSequenceParallelLinear(16, 64)
    row = RowSequenceParallelLinear(64, 16)
    col.set_state_dict({n: tp.to_tensor(w) for n, w in a["col"].items()})
    row.set_state_dict({n: tp.to_tensor(w) for n, w in a["row"].items()})
    xt = tp.to_tensor(a["x_sp"], stop_gradient=False)
    o = all_gather(row(col(scatter(xt))))
    (o * o).sum().backward()
    out["sp"] = (_np(o), _np(xt.grad), _np(col.weight.grad),
                 _np(row.weight.grad))
    return out
