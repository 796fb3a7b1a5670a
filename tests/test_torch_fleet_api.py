"""``distributed.fleet`` (strategies, ``init``, ``distributed_model`` /
``distributed_optimizer``, gradient merge, role makers, ``timer_helper``)
against the JAX package's, and its data-parallel path on 2 spawned gloo
ranks: each rank's half of the batch, the gradients averaged by fleet's
optimizer or by ``DataParallel.apply_collective_grads``, equal to one
rank's step on the whole batch at 1e-6; ``SyncBatchNorm`` over both
ranks' batches equal to ``BatchNorm`` over the whole batch (output, input
gradient, running statistics at 1e-5); ``DistributedBatchSampler``'s
default ranks from the environment.  (The serving fleet's tests are
``test_torch_fleet.py``.)"""
import numpy as np
import pytest

import paddle_tpu as pt
import paddle_tpu_torch as tp
import paddle_tpu_torch.nn as tnn
from paddle_tpu.distributed import fleet as jfleet
from paddle_tpu_torch.core import device as tdevice
from paddle_tpu_torch.distributed import fleet as tfleet
from paddle_tpu_torch.distributed.fleet import topology as ttopo
from paddle_tpu_torch.distributed.fleet.hybrid_optimizer import (
    HybridParallelOptimizer, HybridParallelGradScaler, distributed_scaler)

import _torch_dist
from _torch_copies import differing_units, statement


@pytest.fixture(autouse=True, scope="module")
def on_cpu():
    prev = tdevice._current_device
    tp.set_device("cpu")
    yield
    tdevice._current_device = prev
    ttopo.set_hybrid_communicate_group(None)


# ---- strategies --------------------------------------------------------------
def test_strategy_defaults_match_reference_plus_ep():
    j, t = jfleet.DistributedStrategy(), tfleet.DistributedStrategy()
    assert t.hybrid_configs == dict(j.hybrid_configs, ep_degree=1)
    for k in ("pipeline_configs", "amp_configs", "recompute_configs",
              "sharding", "sharding_configs", "gradient_merge",
              "gradient_merge_configs", "tensor_parallel_configs"):
        assert getattr(t, k) == getattr(j, k), k
    assert repr(t).startswith("DistributedStrategy(hybrid=")


@pytest.mark.parametrize("flag", ["amp", "recompute", "tensor_parallel",
                                  "find_unused_parameters"])
def test_unwired_strategy_flags_raise_with_a_pointer(flag):
    for mod in (jfleet, tfleet):
        s = mod.DistributedStrategy()
        assert getattr(s, flag) is False
        setattr(s, flag, False)
        with pytest.raises(NotImplementedError, match="not a meta-optimizer"):
            setattr(s, flag, True)
    with pytest.raises(AttributeError):
        tfleet.DistributedStrategy().no_such_flag


def test_fleet_init_world_one_and_wrappers():
    f = tfleet.Fleet()
    s = tfleet.DistributedStrategy()
    assert f.init(is_collective=True, strategy=s) is f
    hcg = f.get_hybrid_communicate_group()
    assert hcg.get_data_parallel_world_size() == 1
    assert f.worker_index == 0 and f.worker_num() == 1
    assert f.is_first_worker() and f.is_worker() and not f.is_server()
    f.barrier_worker()
    model = tnn.Linear(4, 4)
    assert f.distributed_model(model) is model
    opt = f.distributed_optimizer(tp.optimizer.SGD(
        learning_rate=0.1, parameters=model.parameters()))
    assert isinstance(opt, HybridParallelOptimizer)
    assert opt.get_lr() == 0.1            # delegates to the inner optimizer
    assert tfleet.worker_index() == 0 and tfleet.worker_num() == 1


def test_pipeline_degree_and_ps_mode_name_their_roadmap_items():
    f = tfleet.Fleet()
    f._hcg = ttopo.HybridCommunicateGroup(
        ttopo.CommunicateTopology(dims=[1, 2, 1, 1, 1, 1]), rank=0)
    from paddle_tpu_torch.parallel import PipelineParallel
    assert isinstance(f.distributed_model(tnn.Linear(2, 2)), PipelineParallel)
    for call in (lambda: f.init(is_collective=False),
                 f.ps_client, f.init_server, f.run_server, f.stop_worker):
        with pytest.raises(NotImplementedError, match="M12 part 3"):
            call()


def test_gradient_merge_matches_reference():
    """reference test_gradient_merge_strategy_wired: k merged micro-steps
    and one averaged update, the same weights as the JAX package's."""
    rng = np.random.RandomState(0)
    xs = [rng.rand(8, 4).astype(np.float32) for _ in range(3)]
    ys = [rng.rand(8, 1).astype(np.float32) for _ in range(3)]
    pt.seed(0)
    w0 = {k: np.asarray(v.numpy()) for k, v in
          pt.nn.Linear(4, 1).state_dict().items()}
    out = {}
    for pkg, mod in ((pt, jfleet), (tp, tfleet)):
        from importlib import import_module
        hyb = import_module(mod.__name__ + ".hybrid_optimizer")
        lin = pkg.nn.Linear(4, 1)
        lin.set_state_dict({k: pkg.to_tensor(v) for k, v in w0.items()})
        opt = pkg.optimizer.SGD(learning_rate=0.1,
                                parameters=lin.parameters())
        strat = mod.DistributedStrategy()
        strat.gradient_merge = True
        strat.gradient_merge_configs = {"k_steps": 3, "avg": True}
        hopt = hyb.HybridParallelOptimizer(opt, strategy=strat)
        for x, y in zip(xs, ys):
            ((lin(pkg.to_tensor(x)) - pkg.to_tensor(y)) ** 2).mean().backward()
            hopt.step()
            hopt.clear_grad()
        out[pkg] = [np.asarray(p.numpy()) for p in lin.parameters()]
    for a, b in zip(out[tp], out[pt]):
        np.testing.assert_allclose(a, b, rtol=1e-6)


def test_grad_scaler_wrappers_delegate():
    scaler = tp.amp.GradScaler(init_loss_scaling=8.0)
    hs = distributed_scaler(scaler)
    assert isinstance(hs, HybridParallelGradScaler)
    lin = tnn.Linear(2, 1)
    opt = HybridParallelOptimizer(tp.optimizer.SGD(
        learning_rate=0.1, parameters=lin.parameters()))
    loss = lin(tp.to_tensor(np.ones((2, 2), np.float32))).sum()
    scaled = hs.scale(loss)
    np.testing.assert_allclose(float(scaled), 8.0 * float(loss), rtol=1e-6)
    scaled.backward()
    before = lin.weight.numpy().copy()
    hs.step(opt)
    assert not np.allclose(lin.weight.numpy(), before)
    assert hs.get_loss_scaling() == scaler.get_loss_scaling()


def test_role_makers_match_reference(monkeypatch):
    env = {"TRAINING_ROLE": "PSERVER",
           "PADDLE_PSERVERS_IP_PORT_LIST": "10.0.0.1:6000,10.0.0.2:6000",
           "PADDLE_TRAINER_ENDPOINTS": "10.0.0.3:0,10.0.0.4:0",
           "POD_IP": "10.0.0.2", "PADDLE_PORT": "6000"}
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    for mod in (jfleet, tfleet):
        rm = mod.PaddleCloudRoleMaker(is_collective=False)
        assert rm.is_server() and not rm.is_worker()
        assert (rm.server_index(), rm.server_num(), rm.role_id()) == (1, 2, 1)
        assert rm.get_pserver_endpoints() == ["10.0.0.1:6000",
                                              "10.0.0.2:6000"]
        assert rm.get_trainer_endpoints() == ["10.0.0.3:0", "10.0.0.4:0"]
    monkeypatch.setenv("PADDLE_PORT", "7000")
    with pytest.raises(ValueError, match="not in"):
        tfleet.PaddleCloudRoleMaker(is_collective=False)
    for k in env:
        monkeypatch.delenv(k)
    rm = tfleet.PaddleCloudRoleMaker(is_collective=True)
    assert rm.is_worker() and rm.is_first_worker() and rm.worker_num() == 1
    u = tfleet.UserDefinedRoleMaker(current_id=1, role=tfleet.Role.SERVER,
                                    worker_num=2,
                                    server_endpoints=["a:1", "b:2"])
    assert u.is_server() and u.server_index() == 1 and u.server_num() == 2
    u2 = tfleet.UserDefinedRoleMaker(current_id=0, role=tfleet.Role.WORKER,
                                     worker_num=2)
    assert u2.is_worker() and u2.worker_num() == 2 and u2.worker_index() == 0


def test_timer_helper_matches_reference():
    from paddle_tpu.distributed.fleet.utils import timer_helper as jt
    from paddle_tpu_torch.distributed.fleet.utils import timer_helper as tt
    for mod in (jt, tt):
        g = mod.TimerGroup()
        g("a").start()
        with pytest.raises(RuntimeError, match="already started"):
            g("a").start()
        g("a").stop(sync=True)
        with pytest.raises(RuntimeError, match="not started"):
            g("a").stop()
        assert g("a").mean(reset=False) >= 0
        assert g.throughput("a", 10) > 0
        assert g.log(["a"]).startswith("time (ms) | a: ")
    tt.set_timers(None)
    assert isinstance(tt.get_timers(), tt.TimerGroup)


def test_meta_parallel_and_mpu_reexports():
    from paddle_tpu_torch.distributed.fleet import meta_parallel, layers
    from paddle_tpu_torch import parallel
    assert layers.mpu.ColumnParallelLinear is parallel.ColumnParallelLinear
    assert meta_parallel.TensorParallel is parallel.TensorParallel
    assert meta_parallel.PipelineParallel is parallel.PipelineParallel
    assert meta_parallel.ZeroBubblePipelineParallel is \
        parallel.ZeroBubblePipelineParallel
    assert meta_parallel.PipelineParallel(None).schedule_mode == "1F1B"


# ---- data parallelism on 2 ranks --------------------------------------------
def _dp_inputs():
    rng = np.random.RandomState(4)
    x = rng.randn(8, 8).astype(np.float32)
    y = rng.randn(8, 4).astype(np.float32)
    tp.seed(2)
    w0 = {k: v.numpy() for k, v in tnn.Linear(8, 4).state_dict().items()}
    return w0, x, y


@pytest.fixture(scope="module")
def dp2(tmp_path_factory):
    w0, x, y = _dp_inputs()
    return _torch_dist.run("fleet_dp", 2, tmp_path_factory.mktemp("f"),
                           w0, x, y)


def test_distributed_model_and_optimizer_average_the_batch(dp2):
    w0, x, y = _dp_inputs()
    lin = tnn.Linear(8, 4)
    lin.set_state_dict({k: tp.to_tensor(v) for k, v in w0.items()})
    ((lin(tp.to_tensor(x)) - tp.to_tensor(y)) ** 2).mean().backward()
    grad = lin.weight.grad.numpy().copy()
    opt = tp.optimizer.SGD(learning_rate=0.1, parameters=lin.parameters())
    opt.step()
    for r in range(2):
        assert dp2[r]["wrapper"] == "DataParallel"
        np.testing.assert_allclose(dp2[r]["dp_weight"], lin.weight.numpy(),
                                   rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(dp2[r]["apply_collective_grads"], grad,
                                   rtol=1e-6, atol=1e-7)


def test_sync_batch_norm_uses_every_ranks_batch(dp2):
    _, x, _ = _dp_inputs()
    bn = tnn.BatchNorm2D(3)
    bn.train()
    xb = tp.to_tensor(x[:, :3].reshape(8, 3, 1, 1), stop_gradient=False)
    ob = bn(xb)
    (ob * ob * tp.to_tensor(np.arange(1.0, 4.0, dtype=np.float32)
                            .reshape(1, 3, 1, 1))).sum().backward()
    for r in range(2):
        o, g, m, v = dp2[r]["sync_bn"]
        np.testing.assert_allclose(o, ob.numpy()[r * 4:(r + 1) * 4],
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(g, xb.grad.numpy()[r * 4:(r + 1) * 4],
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(m, bn._mean.numpy(), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(v, bn._variance.numpy(), rtol=1e-5,
                                   atol=1e-6)


def test_distributed_batch_sampler_default_ranks(dp2):
    from paddle_tpu.io import DistributedBatchSampler, TensorDataset
    for r in range(2):
        nranks, rank, batches = dp2[r]["sampler"]
        assert (nranks, rank) == (2, r)
        j = DistributedBatchSampler(TensorDataset([np.zeros((10, 1))]), 2,
                                    num_replicas=2, rank=r)
        assert batches == list(j)


# ---- copy fidelity of the M12 modules that are copies ----------------------
IMPORT_JAX = statement("import jax")
IMPORT_JNP = statement("import jax.numpy as jnp")
JAX_SHARDING = statement(
    "from jax.sharding import NamedSharding, PartitionSpec as P")
DIVERGENT = {
    # one process a rank: this rank's groups are made at construction, in
    # one order on every rank (torch.distributed.new_group)
    "distributed/fleet/topology.py": {
        "__doc__", IMPORT_JAX, "HybridCommunicateGroup",
        "HybridCommunicateGroup.__init__", "HybridCommunicateGroup._group"},
    # the gradients averaged over the group in buckets of comm_buffer_size
    "distributed/parallel.py": {"__doc__", "DataParallel.__init__",
                                "DataParallel.apply_collective_grads"},
    "parallel/tensor_parallel.py": {"__doc__"},
    # DTensor placements in place of NamedSharding; the vocabulary-parallel
    # lookup and cross entropy shard by shard
    "parallel/mp_layers.py": {
        "__doc__", IMPORT_JAX, IMPORT_JNP, JAX_SHARDING,
        statement("import torch"), statement("from ..core import sharding"),
        statement("from ..distributed.auto_parallel.api import distribute, "
                  "place_param"),
        statement("from ._compat import P, spec_to_placements"),
        "_mp_mesh", "_fit", "_shard_param", "_constrain", "_pce_math",
        "_VocabParallelCE", "_batch_placements", "_local_labels",
        "_vocab_parallel_ce", "vocab_parallel_lookup"},
    # ZeRO's placements as DTensors and sharded optimizer rows; the saved
    # model gathered on rank 0
    "parallel/sharding.py": {
        "__doc__", IMPORT_JAX, IMPORT_JNP, JAX_SHARDING,
        statement("from ..core.tensor import Tensor"),
        statement("from ..distributed.auto_parallel.api import place_param"),
        statement("from ._compat import P, spec_to_placements"),
        "_shard_spec_for", "_axis_size", "shard_accumulators",
        "shard_parameters", "_ShardedModelWrapper", "GroupShardedStage2",
        "save_group_sharded_model",
        # stage 3 gathers a parameter at each use and reduce-scatters its
        # gradient (queue 3, PR 21)
        "gather_sharded"},
    # the dp reduction of plain gradients (one process a rank); no
    # SelectedRows (M13)
    "distributed/fleet/hybrid_optimizer.py": {
        "__doc__", "HybridParallelOptimizer._reduce_dp_grads",
        "HybridParallelOptimizer.step"},
    # the ep degree; the PS plane and pipelines refuse, naming M12 parts 3
    # and 2; dp wraps DataParallel over the dp group
    "distributed/fleet/__init__.py": {
        "__doc__", statement("from ... import _unported"),
        "DistributedStrategy.__init__", "Fleet", "Fleet._init_ps",
        "Fleet.init", "Fleet.init_server", "Fleet.ps_client",
        "Fleet.run_server", "Fleet.stop_worker", "Fleet.distributed_model"},
    # synchronises the card, not a jax device queue
    "distributed/fleet/utils/timer_helper.py": {"__doc__", "Timer.stop"},
    # the placements' translation to DTensor's
    "distributed/auto_parallel/placement.py": {
        "__doc__", "placements_to_spec", "spec_to_placements", "to_torch",
        "from_torch"},
}


@pytest.mark.parametrize("path", sorted(DIVERGENT))
def test_m12_copies_match_the_reference(path):
    assert differing_units(path) == DIVERGENT[path]
