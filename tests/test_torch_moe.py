"""The port's MoE (``parallel/moe.py``) against the JAX package's
(``TestMoE``, ``TestTopKGating``, ``TestExpertParallelAxis``).

``topk_gating`` is held to the reference's (combine, dispatch, aux) at 1e-6
on the same logits; ``MoELayer`` with the same weights on one rank and,
spawned, on 2 gloo ranks at ep = 2 (experts split 2 / 2) and on 4 at
ep = 2 x mp = 2 (the expert FFN's hidden dim split too) against the
reference's layer on its CPU mesh, output, aux loss and every gradient at
1e-5.  ``parallel/moe.py`` is a copy of the reference's; its divergences
are listed in ``DIVERGENT``."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
import paddle_tpu as pt
import paddle_tpu_torch as tp
from paddle_tpu.distributed.fleet.topology import (
    CommunicateTopology, HybridCommunicateGroup, set_hybrid_communicate_group)
from paddle_tpu_torch.core import device as tdevice

import _torch_dist
from _torch_copies import differing_units, statement

TOL = 1e-5
NAMES = ["dp", "pp", "sharding", "sep", "mp", "ep"]


@pytest.fixture(autouse=True, scope="module")
def on_cpu():
    prev = tdevice._current_device
    tp.set_device("cpu")
    yield
    tdevice._current_device = prev


def _set_hcg(**dims):
    d = [dims.get(n, 1) for n in NAMES]
    set_hybrid_communicate_group(HybridCommunicateGroup(
        CommunicateTopology(NAMES, d), rank=0))


# ---- copy fidelity -----------------------------------------------------------
DIVERGENT = {
    "__doc__",
    statement("import jax"), statement("import jax.numpy as jnp"),
    statement("from jax.sharding import NamedSharding, PartitionSpec as P"),
    statement("import torch"), statement("import torch.nn.functional as TF"),
    statement("from ..core import sharding"),
    statement("from ._compat import P"),
    # the mesh's axis names and sizes as the ProcessMesh names them
    "_expert_axes",
    # the gate in torch (a one-hot of the slot by comparison: torch's
    # one_hot refuses an index past the capacity, jax's gives zeros)
    "topk_gating",
    # the experts and the combine run on each rank's shards (DTensor
    # local_map), the gate on every token of every rank; each rank
    # dispatches its own experts' tokens and the combine weights cross to
    # the experts' shards as [S, E] (their gradient gathers [S, E], not the
    # dense [S, E, C])
    "ExpertMLP.forward", "MoELayer.forward", "_ep_dim", "_local_rows",
}


def test_copy_matches_the_reference():
    assert differing_units("parallel/moe.py") == DIVERGENT


# ---- the gate ----------------------------------------------------------------
@pytest.mark.parametrize("S,E,C,K", [(16, 4, 8, 2), (12, 8, 4, 4),
                                     (24, 8, 6, 6), (10, 3, 2, 5)])
def test_topk_gating_matches_reference(S, E, C, K):
    from paddle_tpu.parallel.moe import topk_gating as jg
    from paddle_tpu_torch.parallel.moe import topk_gating as tg
    logits = np.random.RandomState(S + E).randn(S, E).astype(np.float32)
    jc, jd, ja = jg(jnp.asarray(logits), C, k=K)
    tc, td, ta = tg(torch.as_tensor(logits), C, k=K)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-6)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_allclose(float(ta), float(ja), atol=1e-6)


def test_top2_is_topk_two_and_capacity_holds():
    from paddle_tpu_torch.parallel.moe import topk_gating, top2_gating
    logits = torch.as_tensor(np.random.RandomState(0).rand(16, 4)
                             .astype(np.float32))
    c2, d2, a2 = top2_gating(logits, 8)
    ck, dk, ak = topk_gating(logits, 8, k=2)
    assert torch.equal(c2, ck) and float(a2) == float(ak)
    assert c2.shape == (16, 4, 8)
    assert (d2.numpy().sum(axis=(1, 2)) <= 2).all()
    assert (d2.numpy().sum(axis=0) <= 1 + 1e-6).all()
    assert float(a2) > 0


# ---- the layer on one rank ---------------------------------------------------
def _layer_state():
    from paddle_tpu.parallel import MoELayer
    _set_hcg()
    pt.seed(9)
    moe = MoELayer(d_model=16, num_experts=4, d_hidden=32,
                   capacity_factor=2.0)
    return {k: np.asarray(v.numpy()) for k, v in moe.state_dict().items()}


def _reference(dims, state, x):
    from paddle_tpu.parallel import MoELayer
    _set_hcg(**dims)
    try:
        moe = MoELayer(d_model=16, num_experts=4, d_hidden=32,
                       capacity_factor=2.0)
        specs = {n: tuple(p._data.sharding.spec)
                 for n, p in moe.named_parameters()
                 if hasattr(p._data.sharding, "spec")}
        moe.set_state_dict({k: pt.to_tensor(v) for k, v in state.items()})
        xt = pt.to_tensor(x, stop_gradient=False)
        out = moe(xt)
        (out.sum() + moe.aux_loss * 0.01).backward()
        return {"out": out.numpy(), "aux": float(moe.aux_loss),
                "grads": {n: p.grad.numpy() for n, p in
                          moe.named_parameters()},
                "x_grad": xt.grad.numpy(), "specs": specs}
    finally:
        _set_hcg()


def _x():
    return np.random.RandomState(1).rand(2, 8, 16).astype(np.float32)


def _held(got, ref):
    np.testing.assert_allclose(got["out"], ref["out"], rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got["aux"], ref["aux"], rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got["x_grad"], ref["x_grad"], rtol=TOL,
                               atol=TOL)
    assert set(got["grads"]) == set(ref["grads"])
    for n, g in ref["grads"].items():
        np.testing.assert_allclose(got["grads"][n], g, rtol=TOL, atol=TOL,
                                   err_msg=n)


def test_moe_layer_on_one_rank_matches_reference():
    from paddle_tpu_torch.parallel import MoELayer
    state, x = _layer_state(), _x()
    moe = MoELayer(d_model=16, num_experts=4, d_hidden=32,
                   capacity_factor=2.0)
    moe.set_state_dict({k: tp.to_tensor(v) for k, v in state.items()})
    xt = tp.to_tensor(x, stop_gradient=False)
    out = moe(xt)
    (out.sum() + moe.aux_loss * 0.01).backward()
    got = {"out": out.numpy(), "aux": float(moe.aux_loss),
           "grads": {n: p.grad.numpy() for n, p in moe.named_parameters()},
           "x_grad": xt.grad.numpy()}
    _held(got, _reference({}, state, x))


# ---- expert parallelism on spawned ranks ------------------------------------
@pytest.fixture(scope="module", params=[({"ep_degree": 2}, 2),
                                        ({"ep_degree": 2, "mp_degree": 2}, 4)],
                ids=["ep2", "ep2xmp2"])
def ep_pair(request, tmp_path_factory):
    dims, world = request.param
    state, x = _layer_state(), _x()
    got = _torch_dist.run("moe_layer", world, tmp_path_factory.mktemp("moe"),
                          dims, state, x)
    ref = _reference({k.split("_")[0]: v for k, v in dims.items()}, state, x)
    return dims, world, got, ref


def test_ep_moe_layer_matches_reference(ep_pair):
    _, world, got, ref = ep_pair
    for r in range(world):
        _held(got[r], ref)


def test_experts_shard_on_ep_and_hidden_on_mp(ep_pair):
    dims, world, got, ref = ep_pair
    mp = dims.get("mp_degree", 1) > 1
    for r in range(world):
        pl = got[r]["placements"]
        # placements one per axis: dp, pp, sharding, sep, mp, ep
        w1 = pl["experts.w1"]
        assert w1.endswith("Shard(dim=0)]"), w1
        assert ("Shard(dim=2)" in w1) == mp, w1
        assert ("Shard(dim=1)" in pl["experts.w2"]) == mp
        assert pl["gate_w"] == "None"
    assert ref["specs"]["experts.w1"][0] == "ep"
    assert ("mp" in ref["specs"]["experts.w1"]) == mp


def test_moe_model_with_top6_preset_trains():
    """reference TestTopKGating.test_moe_model_with_top6_preset_trains."""
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    tp.seed(0)
    cfg = LlamaConfig.deepseek_moe_16b(
        vocab_size=128, hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=4,
        max_position_embeddings=64, num_experts=8, moe_intermediate_size=32)
    assert cfg.num_experts_per_tok == 6
    model = LlamaForCausalLM(cfg)
    assert model.llama.layers[0].mlp.top_k == 6
    opt = tp.optimizer.AdamW(learning_rate=1e-2,
                             parameters=model.parameters())
    ids = np.random.RandomState(0).randint(0, 128, (2, 17)).astype(np.int32)
    losses = []
    for _ in range(3):
        _, loss = model(tp.to_tensor(ids[:, :-1]),
                        labels=tp.to_tensor(ids[:, 1:]))
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss))
    assert losses[-1] < losses[0]


def test_fleet_init_plumbs_ep_degree():
    from paddle_tpu_torch.distributed import fleet
    strategy = fleet.DistributedStrategy()
    strategy.hybrid_configs = {"ep_degree": 1, "dp_degree": 1}
    f = fleet.Fleet()
    f.init(strategy=strategy)
    hcg = f.get_hybrid_communicate_group()
    assert hcg.get_expert_parallel_world_size() == 1
    assert "ep" in hcg.get_mesh().dim_names
