"""The hybrid-parallel Llama against the JAX package's
``__graft_entry__.dryrun_multichip`` parts A (with and without ``sep``), B
and E.

Each part trains the tiny Layer Llama for 2 AdamW steps from the JAX
model's seeded weights on a hybrid topology: A dense at dp = 2 x mp = 2
(the batch on dp, ``shard_llama`` Megatron TP on mp with FSDP on dp, clip
1.0), A_sep at sep = 2 x mp = 2 (the dryrun's split for four devices: ring
attention over sep), B the MoE Llama at ep = 2 x mp = 2 (experts on ep,
their hidden dim on mp), E ZeRO-3 at dp = 2 x sharding = 2
(``group_sharded_parallel`` ``p_g_os``; the port's batch on dp and
sharding, ZeRO's data-parallel ranks).  The port runs on 4 spawned gloo
ranks (one job for the parts); the reference runs the same topology on its
CPU mesh meanwhile, eagerly (its sharded step's losses are the same as
through ``jit.to_static``, which the dryrun uses and which costs a compile
of each part); A_sep is held to part A's reference run.  Each loss must
be within 3e-5 (the dryrun's bar) of the reference's sharded run and of
the port's replicated run, on every rank; the gradient norms within 1e-4
relative of the replicated run's."""
import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu.nn as jnn
import paddle_tpu_torch as tp
from paddle_tpu.distributed.fleet.topology import (
    CommunicateTopology, HybridCommunicateGroup, set_hybrid_communicate_group)
from paddle_tpu_torch.core import device as tdevice

import _torch_dist
import _torch_dist_cases as cases

BAR = 3e-5
NORM = 1e-4
NAMES = ["dp", "pp", "sharding", "sep", "mp", "ep"]
PARTS = {
    # part: (config kwargs, hybrid degrees, seed, mode, clip)
    "A": ({"num_key_value_heads": 4}, {"dp_degree": 2, "mp_degree": 2}, 0,
          "dense", 1.0),
    "A_sep": ({"num_key_value_heads": 4}, {"sep_degree": 2, "mp_degree": 2},
              0, "dense", 1.0),
    "B": ({"num_experts": 4}, {"ep_degree": 2, "mp_degree": 2}, 1, "moe",
          None),
    "E": ({"num_key_value_heads": 4}, {"dp_degree": 2, "sharding_degree": 2},
          3, "zero3", None),
}


@pytest.fixture(autouse=True, scope="module")
def on_cpu():
    """The CPU, and one torch thread as the spawned ranks have: the tiny
    models gain nothing from more, and the suite's workers share the
    cores."""
    prev, threads = tdevice._current_device, torch.get_num_threads()
    tp.set_device("cpu")
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    tdevice._current_device = prev
    set_hybrid_communicate_group(HybridCommunicateGroup(
        CommunicateTopology(dims=[1, 1, 1, 1, 1]), rank=0))


def _set_hcg(dims):
    d = [dims.get(f"{n}_degree", 1) for n in NAMES]
    hcg = HybridCommunicateGroup(CommunicateTopology(NAMES, d), rank=0)
    set_hybrid_communicate_group(hcg)
    return hcg


def _ids():
    return np.random.RandomState(0).randint(0, 256, (4, 33)).astype(np.int64)


def _reference(part):
    """The JAX package's sharded run of a part on its CPU mesh, as the
    dryrun runs it, eagerly; its losses."""
    from paddle_tpu.distributed import Shard, shard_tensor
    from paddle_tpu.distributed.sharding import group_sharded_parallel
    from paddle_tpu.models.llama import (LlamaConfig, LlamaForCausalLM,
                                         shard_llama)
    cfg_kw, dims, seed, mode, clip = PARTS[part]
    hcg = _set_hcg(dims)
    try:
        pt.seed(seed)
        model = LlamaForCausalLM(LlamaConfig.tiny(**cfg_kw))
        if mode == "dense":
            shard_llama(model, hcg.get_mesh(), fsdp_axis="dp", mp_axis="mp")
        opt = pt.optimizer.AdamW(
            learning_rate=1e-3, parameters=model.parameters(),
            grad_clip=jnn.ClipGradByGlobalNorm(clip) if clip else None)
        if mode == "zero3":
            model, opt = group_sharded_parallel(model, opt, level="p_g_os")
        ids = _ids()
        x, y = pt.to_tensor(ids[:, :-1]), pt.to_tensor(ids[:, 1:])

        def step(x, y):
            _, loss = model(shard_tensor(x, hcg.get_mesh(), [Shard(0)]),
                            labels=y)
            loss.backward()
            opt.step()
            opt.clear_grad()
            return loss
        return [float(np.asarray(step(x, y)._data, np.float32))
                for _ in range(2)]
    finally:
        _set_hcg({})


def _state(part):
    """The JAX model's seeded weights of a part, as numpy."""
    from paddle_tpu.models.llama import LlamaConfig, LlamaForCausalLM
    cfg_kw, _, seed, _, _ = PARTS[part]
    _set_hcg({})
    pt.seed(seed)
    model = LlamaForCausalLM(LlamaConfig.tiny(**cfg_kw))
    return {k: np.asarray(v.numpy()) for k, v in model.state_dict().items()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    states = {p: _state(p) for p in PARTS}
    jobs = [(PARTS[p][0], PARTS[p][1], states[p], _ids(), 2, PARTS[p][3],
             PARTS[p][4]) for p in sorted(PARTS)]
    job = _torch_dist.start("hybrid_parts", 4, tmp_path_factory.mktemp("h"),
                            jobs, timeout=300)
    # the references run while the ranks do.  A_sep's is part A's run: the
    # same model, weights and batch (sep changes where the sequence lives,
    # not the loss; the reference's own dryrun holds its sep run to its
    # replicated run at this bar), and its sharded run through the ring
    # takes minutes of the reference's eager shard_map on the CPU
    refs = {p: _reference(p) for p in PARTS if p != "A_sep"}
    refs["A_sep"] = refs["A"]
    plain = {p: cases.llama_train(0, 1, PARTS[p][0], {}, states[p],
                                  _ids(), 2, "none", PARTS[p][4])
             for p in PARTS}
    return refs, job.results(), plain


@pytest.mark.parametrize("part", sorted(PARTS))
def test_part_matches_reference_sharded_and_port_replicated(runs, part):
    refs, got, plain = runs
    i = sorted(PARTS).index(part)
    np.testing.assert_allclose(plain[part][0], refs[part], atol=BAR, rtol=BAR)
    for r in range(4):
        losses, norms, _ = got[r][i]
        np.testing.assert_allclose(losses, refs[part], atol=BAR, rtol=BAR)
        np.testing.assert_allclose(losses, plain[part][0], atol=BAR, rtol=BAR)
        np.testing.assert_allclose(norms, plain[part][1], rtol=NORM)
    assert losses[1] < losses[0]


def test_part_a_places_megatron_and_fsdp(runs):
    _, got, _ = runs
    pl = got[0][sorted(PARTS).index("A")][2]
    # one placement per axis: dp, pp, sharding, sep, mp, ep
    assert pl["llama.layers.0.self_attn.q_proj.weight"] == \
        "[Shard(dim=0), Replicate(), Replicate(), Replicate(), " \
        "Shard(dim=1), Replicate()]"
    assert pl["llama.layers.0.self_attn.o_proj.weight"].startswith(
        "[Shard(dim=1)")
    assert pl["llama.embed_tokens.weight"].endswith(
        "Shard(dim=0), Replicate()]")
    assert pl["llama.norm.weight"] == "None"


def test_part_b_places_experts_on_ep_and_hidden_on_mp(runs):
    _, got, _ = runs
    pl = got[0][sorted(PARTS).index("B")][2]
    w1 = pl["llama.layers.0.mlp.experts.w1"]
    assert w1.endswith("Shard(dim=2), Shard(dim=0)]"), w1


def test_part_e_shards_parameters_on_the_sharding_axis(runs):
    _, got, _ = runs
    pl = got[0][sorted(PARTS).index("E")][2]
    emb = pl["llama.embed_tokens.weight"]
    assert emb == "[Replicate(), Replicate(), Shard(dim=0), Replicate(), " \
        "Replicate(), Replicate()]", emb


# ---- the collectives of a step, pinned ----------------------------------------
@pytest.fixture(scope="module")
def comms(tmp_path_factory):
    state = _state("E")
    return _torch_dist.run("hybrid_comms", 2, tmp_path_factory.mktemp("c"),
                           state, timeout=120)


def _total(sizes, kind):
    return sum(sizes.get(kind, []))


@pytest.mark.parametrize("mode", ["mp", "zero3"])
def test_step_collectives_are_pinned(comms, mode):
    """One tiny-Llama step's collectives by kind and bytes a rank
    (CommDebugMode's counts, the bytes of each op's input).  ZeRO-3 at
    sharding = 2 (the batch split over it): one all-gather of each
    parameter's rows in the forward (its rows' bytes), none in the
    backward, one reduce-scatter of each gradient (its whole bytes), and
    no all-reduce but the loss's scalar.  Megatron mp = 2: one all-reduce
    of the [B, S, h] activations after the vocabulary-parallel lookup and
    after each layer's o_proj and down_proj, the three [tokens]-sized ones
    of the vocabulary-parallel loss, and the matching all-reduces in the
    backward; no all-gather and no reduce-scatter."""
    for r in range(2):
        res = comms[r][mode]
        (fc, fs), (bc, bs) = res["fwd"], res["bwd"]
        params = res["params"]
        if mode == "zero3":
            assert fc.get("all_gather_into_tensor") == len(params)
            assert _total(fs, "all_gather_into_tensor") == sum(params) * 4 // 2
            assert all(b <= 4 for b in fs.get("all_reduce", []))
            assert bc.get("reduce_scatter_tensor") == len(params)
            assert _total(bs, "reduce_scatter_tensor") == sum(params) * 4
            assert "all_gather_into_tensor" not in bc
            assert "all_reduce" not in bc
        else:
            layers = 2
            act = 4 * 32 * 64 * 4          # [B, S, h] float32
            assert fc.get("all_reduce") == 2 * layers + 1
            assert fs["all_reduce"] == [act] * (2 * layers + 1)
            assert fc.get("allreduce") == 3
            assert bc.get("all_reduce") == 2 * layers + 1
            assert bs["all_reduce"] == [act] * (2 * layers + 1)
            for c in (fc, bc):
                assert "reduce_scatter_tensor" not in c
                assert "all_gather_into_tensor" not in c
