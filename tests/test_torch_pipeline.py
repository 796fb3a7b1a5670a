"""The port's pipeline schedules (``parallel/pipeline_layer.py``,
``parallel/pipeline.py``) and ``backward_split`` against the JAX package.

In one process, a mirror of ``tests/test_pipeline.py`` (13 tests) and of
``tests/test_distributed.py``'s ``TestPipeline``: the tiny Llama's weights
come from the JAX model of the same seed as numpy (the dense model's state
under the pipe's parameter names), and each schedule's losses are held to
the JAX package's dense microbatched run at the reference's tolerance
(1e-5), as the reference holds its own pipelines (the MoE and the tied
pipes to the port's dense model of the same weights, itself held to the
JAX model's in ``test_torch_llama_layer.py``).  On 2 spawned gloo ranks
(one job): pp = 2 under 1F1B, ZB-H1, the interleaved schedule (v = 2) and
FThenB, each rank running only its own chunks (dryrun parts D, F and G),
held to the single-process run of the same schedule and to the JAX dense
microbatched run of the same weights and batches at the dryrun's bars (3e-5
on the losses, 1e-4 relative on the gradient norm); a tied pipe under the
global-norm clip for 3 steps and a pipe whose loss scaler finds a
non-finite gradient on one stage, each held to its single-process run;
and dryrun part C, the SPMD GPipe ``pipeline_forward``
over ``make_decoder_stage`` stages, its output and each rank's stage
gradients against ``jax.grad`` of the reference's stages run in sequence
(the dryrun's twin of its pipeline) at its bars (atol 1e-3, rtol 1e-4;
the norm 1e-4 relative)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import paddle_tpu as pt
from paddle_tpu import ops as jops
from paddle_tpu.models import llama as jl
from paddle_tpu.parallel import pipeline_layer as jpl
import paddle_tpu_torch as tp
from paddle_tpu_torch import ops as tops
from paddle_tpu_torch.core import device as tdevice
from paddle_tpu_torch.models import llama as tl
from paddle_tpu_torch.parallel import pipeline_layer as tpl

import _torch_dist
import _torch_dist_cases
from _torch_copies import differing_units, statement

TOL = dict(atol=1e-5, rtol=1e-5)
DRYRUN = 3e-5


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


def _ids(B=4, S=16, seed=0):
    return np.random.RandomState(seed).randint(0, 256, (B, S + 1)).astype(
        np.int32)


def _xy(pkg, ids):
    return pkg.to_tensor(ids[:, :-1]), pkg.to_tensor(ids[:, 1:])


def _pipe_state(dense, layers):
    """A dense Llama's state under ``LlamaForCausalLMPipe``'s names."""
    out = {}
    for k, v in dense.items():
        if k.startswith("llama.embed_tokens."):
            out["_layers_list.0." + k[len("llama."):]] = v
        elif k.startswith("llama.layers."):
            i, rest = k[len("llama.layers."):].split(".", 1)
            out[f"_layers_list.{int(i) + 1}.{rest}"] = v
        elif k.startswith("llama.norm."):
            out[f"_layers_list.{layers + 1}.{k[len('llama.'):]}"] = v
        else:
            out[f"_layers_list.{layers + 1}.{k}"] = v
    return out


class _NormAdamW:
    """AdamW recording the global gradient norm at each step (the dryrun's
    ``_NormRecordingAdamW``) for either package; given ``clip``, SGD with
    ``ClipGradByGlobalNorm(clip)``, the norm read before the clip."""

    def __init__(self, pkg, params, lr, clip=None):
        if clip is None:
            self.inner = pkg.optimizer.AdamW(learning_rate=lr,
                                             parameters=params)
        else:
            self.inner = pkg.optimizer.SGD(
                learning_rate=lr, parameters=params,
                grad_clip=pkg.nn.ClipGradByGlobalNorm(clip))
        self.norms = []

    def __getattr__(self, name):
        return getattr(self.__dict__["inner"], name)

    def step(self):
        sq = sum(float((np.asarray(p.grad.numpy(), np.float64) ** 2).sum())
                 for p in self.inner._parameter_list if p.grad is not None)
        self.norms.append(sq ** 0.5)
        self.inner.step()

    def clear_grad(self):
        self.inner.clear_grad()


def _dense(pkg, cfg, state, batches, n_micro, lr):
    """The dense Llama from ``state``, its gradients accumulated over
    ``n_micro`` microbatches as the pipelines' are (or the whole batch at
    once, the same gradient of a dense model: its losses agree to 5e-7 and
    its norms to 1e-6 relative): the losses and gradient norms of each
    step."""
    mod = jl if pkg is pt else tl
    model = mod.LlamaForCausalLM(cfg)
    model.set_state_dict({k: pkg.to_tensor(v) for k, v in state.items()})
    opt = _NormAdamW(pkg, model.parameters(), lr)
    split = (jops if pkg is pt else tops).split
    losses = []
    for ids in batches:
        x, y = _xy(pkg, ids)
        total = 0.0
        for xm, ym in zip(split(x, n_micro, axis=0), split(y, n_micro, axis=0)):
            _, loss = model(xm, labels=ym)
            (loss / n_micro).backward()
            total += float((loss / n_micro).numpy())
        opt.step()
        opt.clear_grad()
        losses.append(total)
    return losses, opt.norms


def _jax_state(cfg, seed):
    pt.seed(seed)
    m = jl.LlamaForCausalLM(cfg)
    return {k: np.asarray(v.numpy()) for k, v in m.state_dict().items()}


def _pipe(cfg, state, pp, vpp=None, cls=tpl.PipelineParallel, n_micro=4,
          mode=None):
    pipe = tl.LlamaForCausalLMPipe(cfg, num_stages=pp,
                                   num_virtual_pipeline_stages=vpp)
    missing, unexpected = pipe.set_state_dict(
        {k: tp.to_tensor(v) for k, v in _pipe_state(
            state, cfg.num_hidden_layers).items()})
    assert not missing and not unexpected

    class _Strategy:
        pipeline_configs = {"accumulate_steps": n_micro}
        if mode:
            pipeline_configs["schedule_mode"] = mode
    return cls(pipe, strategy=_Strategy())


def _train(model, batches, lr=1e-2, clip=None, scaler=None):
    opt = _NormAdamW(tp, model.parameters(), lr, clip)
    return [float(model.train_batch(_xy(tp, ids), opt, scaler=scaler))
            for ids in batches], opt.norms


def _cfg(n_layers=4, **kw):
    return (jl.LlamaConfig.tiny(num_hidden_layers=n_layers, **kw),
            tl.LlamaConfig.tiny(num_hidden_layers=n_layers, **kw))


@pytest.fixture(scope="module")
def dense4():
    """The JAX dense 4-layer tiny Llama (seed 0), 3 steps of a batch of 4:
    its state, losses and gradient norms (the reference test's baseline,
    and the dryrun's for parts D, F and G).  A dense model's gradient of
    the whole batch is that of its 4 microbatches accumulated, and one
    pass of JAX's eager ops costs a quarter of four."""
    jcfg, _ = _cfg(4)
    state = _jax_state(jcfg, 0)
    batches = [_ids(seed=s) for s in range(3)]
    losses, norms = _dense(pt, jcfg, state, batches, 1, 1e-2)
    return state, batches, losses, norms


def _tied(state):
    """The tied model's state of a dense one: no lm_head."""
    return {k: v for k, v in state.items() if not k.startswith("lm_head.")}


def _layers(state, n):
    """The state of the model's first ``n`` decoder layers."""
    return {k: v for k, v in state.items()
            if not k.startswith("llama.layers.")
            or int(k.split(".")[2]) < n}


# ---- TestStagePartitioning ----------------------------------------------------
def test_layer_seg_method():
    jcfg, tcfg = _cfg(4)
    pipe = tl.LlamaForCausalLMPipe(tcfg, num_stages=4)
    ref = jl.LlamaForCausalLMPipe(jcfg, num_stages=4)
    assert pipe.num_chunks == 4
    assert pipe._chunk_bounds == ref._chunk_bounds == [(0, 2), (2, 3), (3, 4),
                                                       (4, 6)]
    assert pipe.get_stage_from_index(0) == 0
    assert pipe.get_stage_from_index(5) == 3
    assert list(pipe.state_dict()) == list(ref.state_dict())


def test_vpp_round_robin_assignment():
    _, tcfg = _cfg(4)
    pipe = tl.LlamaForCausalLMPipe(tcfg, num_stages=2,
                                   num_virtual_pipeline_stages=2)
    assert pipe.num_chunks == 4
    assert [pipe.stage_of_chunk(c) for c in range(4)] == [0, 1, 0, 1]


def test_uneven_layer_count_raises():
    _, tcfg = _cfg(3)
    with pytest.raises(ValueError):
        tl.LlamaForCausalLMPipe(tcfg, num_stages=2)


# ---- TestPP1F1B ---------------------------------------------------------------
def test_pp4_loss_parity_vs_dense(dense4):
    state, batches, want, _ = dense4
    _, tcfg = _cfg(4)
    got, _ = _train(_pipe(tcfg, state, 4), batches)
    np.testing.assert_allclose(got, want, **TOL)


def test_1f1b_in_flight_bound(dense4):
    _, tcfg = _cfg(2)
    model = _pipe(tcfg, _layers(dense4[0], 2), 2, n_micro=8)
    _train(model, [_ids(B=8)])
    assert model.max_in_flight == 2


def test_forward_matches_dense_forward(dense4):
    state = dense4[0]
    jcfg, tcfg = _cfg(4)
    dense = jl.LlamaForCausalLM(jcfg)
    dense.set_state_dict({k: pt.to_tensor(v) for k, v in state.items()})
    pipe = _pipe(tcfg, state, 4)._layers
    x, _ = _xy(tp, _ids())
    ref = dense(_xy(pt, _ids())[0])
    np.testing.assert_allclose(pipe(x).numpy(), np.asarray(ref.numpy()),
                               **TOL)


def test_fthenb_keeps_every_microbatch_live(dense4):
    """``schedule_mode = "FThenB"`` (GPipe): the same losses, all M
    microbatches live at once."""
    state, batches, want, _ = dense4
    _, tcfg = _cfg(4)
    model = _pipe(tcfg, state, 4, mode="FThenB")
    assert model.schedule_mode == "FThenB"
    got, _ = _train(model, batches)
    np.testing.assert_allclose(got, want, **TOL)
    assert model.max_in_flight == 4


# ---- TestPPComposition ----------------------------------------------------------
def test_moe_pp_parity_vs_dense():
    """MoE aux loss rides the boundary stream; the pipe holds to the dense
    model of the same (the JAX model's) weights, the port's dense MoE
    Llama being held to the JAX one in ``test_torch_llama_layer.py``."""
    jcfg = jl.LlamaConfig.tiny_moe(num_hidden_layers=4)
    tcfg = tl.LlamaConfig.tiny_moe(num_hidden_layers=4)
    state = _jax_state(jcfg, 0)
    batches = [_ids(seed=s) for s in range(2)]
    want, _ = _dense(tp, tcfg, state, batches, 4, 1e-2)
    got, _ = _train(_pipe(tcfg, state, 2), batches)
    np.testing.assert_allclose(got, want, **TOL)


def test_tied_embeddings_pinned_stages(dense4):
    """The tied embedding is shared across stage 0 and the last stage; it
    appears once in parameters(); pinned to a 'pp' mesh the pipeline
    trains as the dense model does."""
    from paddle_tpu_torch.distributed import ProcessMesh
    _, tcfg = _cfg(4, tie_word_embeddings=True)
    state = _tied(dense4[0])
    model = _pipe(tcfg, state, 4, n_micro=2)
    pipe = model._layers
    pipe.pin_stages(ProcessMesh(np.arange(4), ["pp"]), axis_name="pp")
    names = [n for n, _ in pipe.named_parameters()]
    assert len(names) == len(set(names))
    got, _ = _train(model, [_ids()], lr=1e-3)
    want, _ = _dense(tp, tcfg, state, [_ids()], 2, 1e-3)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, **TOL)


# ---- TestZeroBubble -------------------------------------------------------------
def test_zb_loss_parity_vs_dense(dense4):
    state, batches, want, _ = dense4
    _, tcfg = _cfg(4)
    model = _pipe(tcfg, state, 4, cls=tpl.ZeroBubblePipelineParallel)
    assert model.schedule_mode == "ZB-H1"
    got, _ = _train(model, batches)
    assert model.w_deferred_total > 0
    np.testing.assert_allclose(got, want, **TOL)


def test_zb_defers_weight_grads():
    """Until the W queue runs, parameter .grad stays empty while the
    chunk-boundary activation grads have already propagated; then both
    equal a joint backward and the reference's."""
    from paddle_tpu_torch.autograd.backward import backward_split
    from paddle_tpu.autograd.backward import backward_split as jsplit
    a = np.random.RandomState(0).randn(4, 8).astype(np.float32)
    pt.seed(0)
    jlin = pt.nn.Linear(8, 8)
    state = {k: np.asarray(v.numpy()) for k, v in jlin.state_dict().items()}
    res = []
    for pkg, split in ((tp, backward_split), (pt, jsplit)):
        lin = pkg.nn.Linear(8, 8)
        lin.set_state_dict({k: pkg.to_tensor(v) for k, v in state.items()})
        x = pkg.to_tensor(a, stop_gradient=False)
        y = lin(x)
        deferred = split([(y * y).mean()], [None],
                         {id(p) for p in lin.parameters()})
        assert x.grad is not None
        assert all(p.grad is None for p in lin.parameters())
        assert len(deferred) >= 1
        for w in deferred:
            w()
        res.append([np.asarray(t.grad.numpy()) for t in
                    [x] + list(lin.parameters())])
    ref_lin = tp.nn.Linear(8, 8)
    ref_lin.set_state_dict({k: tp.to_tensor(v) for k, v in state.items()})
    x2 = tp.to_tensor(a, stop_gradient=False)
    (ref_lin(x2) * ref_lin(x2)).mean().backward()
    joint = [x2.grad.numpy()] + [p.grad.numpy() for p in ref_lin.parameters()]
    for got, want, ref in zip(res[0], joint, res[1]):
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)
        np.testing.assert_allclose(got, ref, atol=1e-6, rtol=1e-6)


# ---- TestInterleave -------------------------------------------------------------
def test_interleave_parity_vs_dense(dense4):
    state, batches, want, _ = dense4
    _, tcfg = _cfg(4)
    model = _pipe(tcfg, state, 2, vpp=2,
                  cls=tpl.PipelineParallelWithInterleave)
    assert model.schedule_mode == "interleave"
    got, _ = _train(model, batches[:2])
    np.testing.assert_allclose(got, want[:2], **TOL)


def test_requires_vpp_container():
    _, tcfg = _cfg(4)
    pipe = tl.LlamaForCausalLMPipe(tcfg, num_stages=2)
    with pytest.raises(ValueError):
        tpl.PipelineParallelWithInterleave(pipe)


@pytest.mark.parametrize("M,P,V", [(4, 2, 2), (8, 4, 2), (6, 3, 3), (4, 4, 1)])
def test_schedule_structure(M, P, V):
    """Warmup depth and op counts follow the Megatron interleave formula,
    and every rank's op list is the reference's."""
    for rank in range(P):
        sched = tpl.interleave_schedule(M, P, V, rank)
        assert sched == jpl.interleave_schedule(M, P, V, rank)
        fwd = [s for s in sched if s[0] == "F"]
        bwd = [s for s in sched if s[0] == "B"]
        assert len(fwd) == M * V and len(bwd) == M * V
        warmup = min((P - rank - 1) * 2 + (V - 1) * P, M * V)
        assert all(s[0] == "F" for s in sched[:warmup])
        if warmup < M * V:
            assert sched[warmup + 1][0] == "B"
        assert len({(m, c) for _, m, c in fwd}) == M * V
        assert len({(m, c) for _, m, c in bwd}) == M * V


# ---- test_distributed.py TestPipeline, in one process ----------------------------
def test_spmd_pipeline_matches_sequential():
    from paddle_tpu_torch.parallel import pipeline_forward
    rng = np.random.RandomState(3)
    Ws = rng.rand(4, 8, 8).astype(np.float32) * 0.5
    xs = rng.rand(6, 2, 8).astype(np.float32)
    out = pipeline_forward(lambda w, x: torch.tanh(x @ w), torch.tensor(Ws),
                           torch.tensor(xs), axis_name="pp")
    ref = xs.copy()
    for s in range(4):
        ref = np.tanh(ref @ Ws[s])
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-4, atol=1e-5)


def test_pipeline_layer_partition_forward_and_train_batch():
    from paddle_tpu_torch.parallel import (PipelineLayer, LayerDesc,
                                           PipelineParallel, SharedLayerDesc)
    from paddle_tpu_torch.distributed.fleet import DistributedStrategy
    import paddle_tpu_torch.nn as nn
    tp.seed(8)
    pl = PipelineLayer([LayerDesc(nn.Linear, 8, 8) for _ in range(6)],
                       num_stages=2)
    assert pl.get_stage_from_index(0) == 0
    assert pl.get_stage_from_index(5) == 1
    assert pl(tp.randn([2, 8])).shape == [2, 8]
    strategy = DistributedStrategy()
    strategy.pipeline_configs = {"accumulate_steps": 4, "micro_batch_size": 2}
    model = PipelineLayer([LayerDesc(nn.Linear, 4, 8), LayerDesc(nn.ReLU),
                           LayerDesc(nn.Linear, 8, 1)], num_stages=2,
                          loss_fn=nn.MSELoss())
    pp = PipelineParallel(model, None, strategy)
    opt = tp.optimizer.SGD(learning_rate=0.1, parameters=model.parameters())
    rng = np.random.RandomState(9)
    x = tp.to_tensor(rng.rand(8, 4).astype(np.float32))
    y = tp.to_tensor(rng.rand(8, 1).astype(np.float32))
    l0 = float(pp.train_batch((x, y), opt))
    for _ in range(20):
        last = float(pp.train_batch((x, y), opt))
    assert last < l0
    tied = PipelineLayer([
        SharedLayerDesc("emb", nn.Linear, None, "weight", 4, 4),
        SharedLayerDesc("emb", nn.Linear, None, "weight", 4, 4)],
        num_stages=1)
    assert tied.run_functions[0][0].weight is tied.run_functions[1][0].weight


# ---- pp = 2 over launched ranks, and dryrun part C ------------------------------
RANK_RUNS = ["1F1B", "ZB-H1", "VPP", "FThenB"]
CLIP = 0.05          # well under the first step's gradient norm (about 0.5)


def _part_c():
    """Dryrun part C's inputs at the tiny width on 2 stages, and the output
    and gradient (``jax.grad`` of sum(out ** 2)) of the reference's stages
    run in sequence: the dryrun's own twin of its pipeline, to which it
    holds the pipeline's gradients at these bars."""
    jcfg = jl.LlamaConfig.tiny()
    init, apply = jl.make_decoder_stage(jcfg)
    stacked = jax.vmap(init)(jax.random.split(jax.random.PRNGKey(0), 2))
    xs = jnp.asarray(np.random.RandomState(0).rand(4, 2, 16, 64).astype(
        np.float32))

    def seq_loss(ws):
        outs = []
        for m in range(xs.shape[0]):
            h = xs[m]
            for s in range(2):
                h = apply(jax.tree_util.tree_map(lambda leaf: leaf[s], ws), h)
            outs.append(h)
        out = jnp.stack(outs)
        return jnp.sum(out ** 2), out
    (_, out), g = jax.jit(jax.value_and_grad(seq_loss, has_aux=True))(stacked)
    np_stacked = {k: np.asarray(v) for k, v in stacked.items()}
    return (np_stacked, np.asarray(xs), {}), np.asarray(out), \
        {k: np.asarray(v) for k, v in g.items()}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, dense4):
    """The rank job (every schedule from dense4's weights and batches, and
    a tied pipe trained 3 steps under the global-norm clip), and meanwhile
    the single-process run of each."""
    state, batches, _, _ = dense4
    _, tcfg = _cfg(4)
    runs = [dict(name=name, mode=name, cfg={"num_hidden_layers": 4},
                 state=_pipe_state(state, 4), batches=batches[:2], n_micro=4,
                 lr=1e-2) for name in RANK_RUNS]
    tied_cfg = {"num_hidden_layers": 4, "tie_word_embeddings": True}
    tied = _tied(state)
    runs.append(dict(name="clip", mode="1F1B", cfg=tied_cfg,
                     state=_pipe_state(tied, 4), batches=batches, n_micro=2,
                     lr=0.5, clip=CLIP))
    runs.append(dict(name="scaler", mode="1F1B",
                     cfg={"num_hidden_layers": 4},
                     state=_pipe_state(state, 4), batches=batches, n_micro=4,
                     lr=1e-2, scaler=True))
    part_c, c_out, c_grads = _part_c()
    job = _torch_dist.start("pipeline_runs", 2, tmp_path_factory.mktemp("pp"),
                            runs, part_c, timeout=180)
    single = {}
    for name in RANK_RUNS:
        cls = {"VPP": tpl.PipelineParallelWithInterleave,
               "ZB-H1": tpl.ZeroBubblePipelineParallel}.get(
                   name, tpl.PipelineParallel)
        model = _pipe(tcfg, state, 2, vpp=2 if name == "VPP" else None,
                      cls=cls, mode="FThenB" if name == "FThenB" else None)
        single[name] = _train(model, batches[:2])
    model = _pipe(tl.LlamaConfig.tiny(**tied_cfg), tied, 2, n_micro=2)
    single["clip"] = _train(model, batches, lr=0.5, clip=CLIP) + (
        model._layers.state_dict()["_layers_list.0.embed_tokens.weight"]
        .numpy(),)
    single["scaler"] = _train(_pipe(tcfg, state, 2), batches,
                              scaler=_torch_dist_cases._InfOnce(True))
    return job.results(), single, (c_out, c_grads)


@pytest.mark.parametrize("name", RANK_RUNS)
def test_ranks_match_the_single_process_run_and_the_dense_reference(
        ranks, dense4, name):
    got, single, _ = ranks
    _, _, want, want_norms = dense4
    want, want_norms = want[:2], want_norms[:2]
    for r in range(2):
        res = got[r][name]
        np.testing.assert_allclose(res["losses"], single[name][0],
                                   atol=1e-6, rtol=1e-6)
        np.testing.assert_allclose(res["norms"], single[name][1], rtol=1e-5)
        np.testing.assert_allclose(res["losses"], want, atol=DRYRUN,
                                   rtol=DRYRUN)
        np.testing.assert_allclose(res["norms"], want_norms, rtol=1e-4)
        assert res["in_flight"] <= (4 if name in ("VPP", "FThenB") else 2)
    assert got[0]["ZB-H1"]["w_deferred"] > 0


def test_ranks_clip_by_the_global_norm_and_keep_the_tie(ranks):
    """A tied embedding and head on stages 0 and 1, SGD under
    ``ClipGradByGlobalNorm`` for 3 steps: every step's clip sees the norm
    over both stages (the tied weight once), so the losses and norms are
    the single process's, and the two copies of the tied weight stay equal
    to each other and to its one weight."""
    got, single, _ = ranks
    losses, norms, embed = single["clip"]
    assert norms[0] > 4 * CLIP
    for r in range(2):
        res = got[r]["clip"]
        np.testing.assert_allclose(res["losses"], losses, atol=1e-6,
                                   rtol=1e-6)
        np.testing.assert_allclose(res["norms"], norms, rtol=1e-5)
        np.testing.assert_allclose(res["embed"], embed, atol=1e-6, rtol=1e-6)
    np.testing.assert_array_equal(got[0]["clip"]["embed"],
                                  got[1]["clip"]["embed"])


def test_ranks_skip_a_step_together(ranks):
    """A loss scaler that finds a non-finite gradient on the last stage
    alone at the first step: both stages skip it (the step's norm is never
    read), as the one scaler of a single process does, and train on."""
    got, single, _ = ranks
    losses, norms = single["scaler"]
    assert len(norms) == 2
    for r in range(2):
        res = got[r]["scaler"]
        np.testing.assert_allclose(res["losses"], losses, atol=1e-6,
                                   rtol=1e-6)
        np.testing.assert_allclose(res["norms"], norms, rtol=1e-5)


def test_part_c_spmd_gpipe_matches_jax_grad(ranks):
    got, _, (c_out, c_grads) = ranks
    sq = 0.0
    for r in range(2):
        res = got[r]["C"]
        np.testing.assert_allclose(res["out"], c_out, atol=1e-5, rtol=1e-5)
        assert res["others_zero"]
        for k, g in res["grads"].items():
            np.testing.assert_allclose(g, c_grads[k][r], atol=1e-3, rtol=1e-4)
            sq += float((g.astype(np.float64) ** 2).sum())
    gn_ref = float(np.sqrt(sum((g.astype(np.float64) ** 2).sum()
                               for g in c_grads.values())))
    assert abs(sq ** 0.5 - gn_ref) <= 1e-4 * max(gn_ref, 1.0)


# the units that differ from the reference's, each for a reason:
DIVERGENT = {
    "parallel/pipeline_layer.py": {
        "__doc__", statement("import jax"), statement("import torch"),
        statement("from ..core.tensor import Tensor"),
        statement("from ..core.tensor import Tensor, _wrap"),
        statement("import contextlib"),
        # the boundary leaf and its float test in torch, with no device hop
        # (one process drives one card)
        "_is_float_tensor", "_as_leaf", "_hop_cot", "_as_leaf_struct",
        # one runner of every schedule's op lists (_Schedule) over two
        # transports: a dict when one process runs every stage (_Local),
        # sends and receives when each launched rank keeps its own chunks
        # (_P2P); the shared weights' gradients summed between their
        # stages, a loss scaler's skip agreed and the global-norm clip
        # summed over the stages; FThenB selectable
        "PipelineLayer.__init__", "PipelineLayer.forward",
        "PipelineLayer.pin_stages", "PipelineLayer._shared_users",
        "PipelineLayer._localize", "PipelineLayer._sync_shared_grads",
        statement("_DTYPES = [torch.float32, torch.bfloat16, torch.float16, "
                  "torch.float64, torch.int32, torch.int64, torch.bool, "
                  "torch.uint8, torch.int8]"),
        statement("_HEADER = 64"), "_members", "_struct", "_Local", "_P2P",
        "_Schedule", "_skip_together", "_one_f_one_b",
        "PipelineParallel.__init__", "PipelineParallel._rank_stage",
        "PipelineParallel._ops", "PipelineParallel._forward_micro",
        "PipelineParallel._backward_micro",
        "PipelineParallel._train_batch_impl", "PipelineParallel.eval_batch",
        "PipelineParallelWithInterleave._ops",
        "PipelineParallelWithInterleave.train_batch",
        # its docstring says what W recomputes
        "ZeroBubblePipelineParallel",
    },
    "parallel/pipeline.py": {
        "__doc__", statement("import functools"), statement("import jax"),
        statement("import jax.numpy as jnp"), statement("import torch"),
        statement("from jax.sharding import NamedSharding, "
                  "PartitionSpec as P"),
        statement("from ._compat import shard_map"),
        statement("from ..distributed.collective import mesh_ppermute"),
        statement("from ..distributed.collective import mesh_ppermute, "
                  "_axis_group"),
        # one process a stage rank: the ticks in torch, the last stage's
        # output broadcast (shard_map's replicated result)
        "_tree_map", "_leaves", "_FromLast", "pipeline_forward",
        "pipeline_call",
    },
}


@pytest.mark.parametrize("path", sorted(DIVERGENT))
def test_copy_matches_the_reference(path):
    assert differing_units(path) == DIVERGENT[path]
