"""paddle.distributed surface: counterpart of ``paddle_tpu/distributed/``
(reference: python/paddle/distributed/__init__.py).

One process is one rank, on ``torch.distributed``: ``init_parallel_env``
joins the process group (NCCL when every rank has a card of its own, gloo
with the ``staged`` backend for CUDA tensors when ranks share a card, gloo
on the CPU), shardings are DTensor placements over the hybrid topology's
``DeviceMesh``, and the collectives are torch's.  The serving fleet's
control plane is here too (:mod:`.store`, :mod:`.membership`).

Names of modules the port does not have yet stay on the surface and raise
``NotImplementedError`` naming their ROADMAP item: ``CommTaskManager``
(watchdog), ``checkpoint``, ``ps_sparse``, ``rpc`` (M12 part 3).  The
hybrid-parallel schedules are here by module name too:
``sequence_parallel``, ``ring_attention``, ``ulysses``, ``pipeline`` and
``pipeline_layer`` are :mod:`paddle_tpu_torch.parallel`'s.
"""
from .env import (ParallelEnv, get_rank, get_world_size, init_parallel_env,  # noqa: F401
                  is_initialized, get_store, parallel_device_count)
from .parallel import DataParallel  # noqa: F401
from .auto_parallel.api import (ProcessMesh, shard_tensor, reshard, shard_layer,  # noqa: F401
                                dtensor_from_fn, unshard_dtensor,
                                shard_optimizer, local_map, get_placements,
                                get_process_mesh, set_mesh, get_mesh)
from .auto_parallel.placement import (Placement, Replicate, Shard, Partial)  # noqa: F401
from .auto_parallel import (parallelize, to_distributed, Engine, Strategy,  # noqa: F401
                            ColWiseParallel, RowWiseParallel,
                            SequenceParallelBegin, SequenceParallelEnd,
                            SequenceParallelEnable)
from .collective import (all_reduce, all_gather, all_gather_object, reduce,  # noqa: F401
                         broadcast, scatter, all_to_all, reduce_scatter,
                         send, recv, barrier, new_group, get_group, ReduceOp,
                         split_group, broadcast_object_list, alltoall,
                         all_to_all_single, gather, gather_object,
                         scatter_object_list, isend, irecv, wait, P2POp,
                         batch_isend_irecv, destroy_process_group, Group,
                         all_reduce_grads)
from . import mesh_utils  # noqa: F401
from .mesh_utils import create_mesh, create_hybrid_mesh  # noqa: F401
from . import fleet  # noqa: F401
from . import sharding  # noqa: F401
from .. import _unported

_P3 = _unported.M12_PART3
CommTaskManager = _unported.cls("paddle.distributed.CommTaskManager", _P3)
watchdog = _unported.Module("paddle.distributed.watchdog", _P3)
checkpoint = _unported.Module("paddle.distributed.checkpoint", _P3)
ps_sparse = _unported.Module("paddle.distributed.ps_sparse", _P3)
ps = _unported.Module("paddle.distributed.ps", _P3)
rpc = _unported.Module("paddle.distributed.rpc", _P3)
auto_tuner = _unported.Module("paddle.distributed.auto_tuner", _P3)


def spawn(func, args=(), nprocs=-1, join=True, daemon=False, **options):
    """reference: distributed/spawn.py:463 — single-node multiprocess launch.
    Children can call init_parallel_env(): a rendezvous on a free port is
    provisioned here (the default ``nprocs`` is the cards there are, or
    1)."""
    import multiprocessing as mp
    import socket
    if nprocs == -1:
        nprocs = parallel_device_count()
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    ctx = mp.get_context("spawn")
    procs = []
    for rank in range(nprocs):
        env = {"PADDLE_TRAINER_ID": str(rank),
               "PADDLE_TRAINERS_NUM": str(nprocs),
               "PADDLE_LOCAL_RANK": str(rank),
               "PADDLE_LOCAL_SIZE": str(nprocs),
               "PADDLE_MASTER": f"127.0.0.1:{port}",
               "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port)}
        p = ctx.Process(target=_spawn_entry, args=(func, args, env),
                        daemon=daemon)
        p.start()
        procs.append(p)
    if join:
        for p in procs:
            p.join()
        bad = [p.exitcode for p in procs if p.exitcode != 0]
        if bad:
            raise RuntimeError(f"spawn: worker(s) failed with exit codes {bad}")
    return procs


def _spawn_entry(func, args, env):
    import os
    os.environ.update(env)
    func(*args)


_PARALLEL_MODULES = ("sequence_parallel", "ring_attention", "ulysses",
                     "pipeline", "pipeline_layer")


def __getattr__(name):
    # the schedules' modules live in paddle_tpu_torch.parallel, which
    # imports this package: resolved on first use
    if name in _PARALLEL_MODULES:
        import importlib
        return importlib.import_module(f"paddle_tpu_torch.parallel.{name}")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
