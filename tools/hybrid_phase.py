#!/usr/bin/env python3
"""The ``hybrid`` phase of ``chip_smoke.py``: hybrid-parallel training
(``paddle_tpu_torch.distributed``: fleet, DTensor shardings, ZeRO, MoE with
expert parallelism, recompute) on one CUDA card.

This file is the phase's worker script, run in three ways:

- ``python3 -m paddle_tpu_torch.distributed.launch --nproc_per_node 2
  tools/hybrid_phase.py --ranks --out DIR``: two ranks sharing the card
  (the backend ``init_parallel_env`` picks and logs), one process group for
  all of (a) the tiny float32 Llama under dp / mp / sharding = 2 and the
  tiny MoE Llama under ep = 2, each beside a replicated single-rank run of
  the same global batch made in the rank itself; (b) ``bench.py``
  ``_llama_child``'s Llama (bf16, B8 S1024) under dp = 2 (DataParallel,
  the batch split 4 / 4), mp = 2 (``shard_llama``, K1-K3 on each rank's
  heads) and sharding = 2 (ZeRO-3); (c) DeepSeekMoE-16B's width cut to 2
  layers (bf16, B4 S1024) under ep = 2.  Each rank writes
  ``DIR/ranks.<rank>.json``.
- ``python3 tools/hybrid_phase.py --twin --out DIR``: one process, NCCL at
  world size 1 through ``fleet.init`` with every degree 1: the replicated
  twins of (b) and (c) at the same seeds, and GPT-2 124M
  (``bench.py``'s configuration) with ``use_recompute`` on and off.
  Writes ``DIR/twin.json``.
- ``python3 -m paddle_tpu_torch.distributed.launch --nproc_per_node 2
  tools/hybrid_phase.py --pp-sep-ranks --out DIR``: (d) the pipeline and
  the 'sep' axis on the two ranks: a 32 MB exchange over the CUDA backend;
  the ring's kernels against its plain twin at the sep run's shapes;
  ``_llama_child`` at pp = 2 (``LlamaForCausalLMPipe``, 4 microbatches)
  under 1F1B, the interleaved schedule and ZB-H1, at sep = 2 (the
  sequence split, ring and Ulysses attention on K1-K3), and dryrun part C
  (``pipeline_forward`` over two f32 decoder stages at hidden 2048).
  Writes ``DIR/pp_sep.<rank>.json``.
- ``python3 tools/hybrid_phase.py --pp-sep-twin --out DIR``: (d)'s NCCL
  world-1 twins (the microbatched and the full-batch step, part C's
  stages in sequence).  Writes ``DIR/pp_sep_twin.json``.
- ``python3 tools/hybrid_phase.py [--phase hybrid|pipeline_sep|both]`` from
  the root of a checkout: builds the flash kernels and the ``staged``
  backend, then runs ``chip_smoke.hybrid_phase`` and / or
  ``chip_smoke.pipeline_sep_phase`` (the jobs above and their checks).
"""
import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

SEED = 0
TINY_STEPS = 2                 # (a): AdamW steps of each tiny run
FULL_STEPS = 4                 # (b): steps of each full-width run
MOE_STEPS = 3                  # (c): steps of the MoE run
MOE_LAYERS = 2                 # (c): DeepSeekMoE-16B cut to 2 layers
MOE_B, MOE_S = 4, 1024
GPT2_STEPS = 3                 # recompute: steps with and without


def full_config():
    """``bench.py`` ``_llama_child``'s geometry on the Layer Llama's config
    (hidden 2048, 4 layers, GQA 16:4, D 128, FFN 7168, tied 32k vocab),
    with its batch and sequence."""
    from paddle_tpu_torch.models.llama import LlamaConfig
    return LlamaConfig(vocab_size=32000, hidden_size=2048,
                       intermediate_size=7168, num_hidden_layers=4,
                       num_attention_heads=16, num_key_value_heads=4,
                       max_position_embeddings=1024,
                       tie_word_embeddings=True), 8, 1024


def moe_config():
    from paddle_tpu_torch.models.llama import LlamaConfig
    return LlamaConfig.deepseek_moe_16b(num_hidden_layers=MOE_LAYERS), \
        MOE_B, MOE_S


def _adamw(model, lr=3e-4, decay=0.01):
    """``bench.py``'s optimizer: AdamW(3e-4, decay 0.01) with
    ClipGradByGlobalNorm(1.0)."""
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import AdamW
    return AdamW(learning_rate=lr, weight_decay=decay,
                 parameters=model.parameters(),
                 grad_clip=ClipGradByGlobalNorm(1.0))


def grad_norm(params):
    """The global gradient norm (a collective for sharded gradients:
    every rank calls it)."""
    from paddle_tpu_torch.core import sharding
    sq = None
    for p in params:
        if p.grad is not None:
            s = torch.sum(torch.square(p.grad._buf.float()))
            sq = s if sq is None else sq + s
    return float(sharding.full(sq)) ** 0.5


def _launches():
    from paddle_tpu_torch.ops.flash_attention import flash_attention_bshd as f
    return {"K1": f.launches_fwd, "K2": f.launches_dq, "K3": f.launches_dkv}


def _reset_launches():
    from paddle_tpu_torch.ops.flash_attention import flash_attention_bshd as f
    f.launches_fwd = f.launches_dq = f.launches_dkv = 0


def _comm_counts():
    """The staged backend's calls and bytes by kind (empty without it)."""
    import torch.distributed as dist
    from paddle_tpu_torch.distributed import staged
    if staged.NAME.upper() not in dist.Backend._plugins:
        return {}
    return {k: list(v) for k, v in staged.load().counts().items()}


def _reset_comm():
    import torch.distributed as dist
    from paddle_tpu_torch.distributed import staged
    if staged.NAME.upper() in dist.Backend._plugins:
        staged.load().reset_counts()


def _aux(model):
    """The MoE layers' summed aux loss (None for a model without one)."""
    aux = None
    llama = getattr(model, "llama", None)
    for layer in llama.layers if llama is not None else ():
        a = getattr(layer.mlp, "aux_loss", None)
        if a is not None:
            aux = a if aux is None else aux + a
    return None if aux is None else float(aux)


def run_steps(model, opt, batch, steps, timed_from=1, post=None):
    """``steps`` train steps on ``batch`` = (x, y) (Tensors, already placed):
    losses, the gradient norm and aux loss of each step (read after the
    backward and, for the eager dp reduction, after the optimizer's step),
    each step's wall ms, the card's peak memory, the staged collectives a
    timed step and the flash launches."""
    x, y = batch
    losses, norms, auxes, ms = [], [], [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    for i in range(steps):
        if i == timed_from:
            _reset_comm()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, loss = model(x, labels=y)
        loss.backward()
        if post is None:
            norms.append(grad_norm(model.parameters()))
        opt.step()
        if post is not None:
            norms.append(post())
        opt.clear_grad()
        losses.append(float(loss))
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        auxes.append(_aux(model))
    comm = _comm_counts()
    n = max(steps - timed_from, 1)
    return {"losses": losses, "norms": norms, "aux": auxes, "ms": ms,
            "peak_gb": torch.cuda.max_memory_allocated() / 2 ** 30,
            "comm_per_step": {k: [c / n, b / n] for k, (c, b) in comm.items()},
            "launches": _launches()}


def _ids(vocab, b, s, seed):
    rng = np.random.RandomState(seed)
    return rng.randint(0, vocab, (b, s + 1)).astype(np.int64)


def _hybrid(**degrees):
    from paddle_tpu_torch.distributed import fleet
    strategy = fleet.DistributedStrategy()
    hc = {"dp_degree": 1, "mp_degree": 1, "pp_degree": 1,
          "sharding_degree": 1, "sep_degree": 1, "ep_degree": 1}
    hc.update({f"{k}_degree": v for k, v in degrees.items()})
    strategy.hybrid_configs = hc
    fleet.init(is_collective=True, strategy=strategy)
    return fleet.get_hybrid_communicate_group()


def _neutral():
    """A topology of one rank: the replicated runs inside a rank."""
    from paddle_tpu_torch.distributed.fleet.topology import (
        CommunicateTopology, HybridCommunicateGroup,
        set_hybrid_communicate_group)
    set_hybrid_communicate_group(HybridCommunicateGroup(
        CommunicateTopology(dims=[1] * 6), rank=0))


def _free():
    import gc
    gc.collect()
    torch.cuda.empty_cache()


# ---------------------------------------------------------------- (a) tiny
def tiny_run(kind, dev, ids):
    """One tiny float32 run: kind "replicated", "dp", "mp", "sharding" or
    "ep" (the MoE model); returns (losses, norms)."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.distributed import Shard, shard_tensor
    from paddle_tpu_torch.distributed.sharding import group_sharded_parallel
    from paddle_tpu_torch.models.llama import (LlamaConfig, LlamaForCausalLM,
                                               shard_llama)
    moe = kind in ("ep", "replicated_moe")
    if kind.startswith("replicated"):
        _neutral()
        hcg = None
    else:
        hcg = _hybrid(**{kind: 2})
    paddle.seed(SEED + 1)
    model = LlamaForCausalLM(LlamaConfig.tiny_moe() if moe
                             else LlamaConfig.tiny())
    if kind == "mp":
        shard_llama(model, hcg.get_mesh(), fsdp_axis="dp", mp_axis="mp")
    opt = _adamw(model, lr=1e-3)
    if kind == "sharding":
        model, opt = group_sharded_parallel(model, opt, level="p_g_os")
    x, y = paddle.to_tensor(ids[:, :-1]), paddle.to_tensor(ids[:, 1:])
    if hcg is not None:
        x = shard_tensor(x, hcg.get_mesh(), [Shard(0)])
    losses, norms = [], []
    for _ in range(TINY_STEPS):
        _, loss = model(x, labels=y)
        loss.backward()
        norms.append(grad_norm(model.parameters()))
        opt.step()
        opt.clear_grad()
        losses.append(float(loss))
    return losses, norms


def part_a(dev):
    ids = _ids(256, 4, 32, SEED + 2)
    out = {}
    for kind in ("dp", "mp", "sharding", "ep"):
        ref = "replicated_moe" if kind == "ep" else "replicated"
        out[kind] = {"run": tiny_run(kind, dev, ids),
                     "replicated": tiny_run(ref, dev, ids)}
    return out


# ----------------------------------------------------------- (b) full width
def full_model(dev, sep_backend="ring"):
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.models.llama import LlamaForCausalLM
    cfg, b, s = full_config()
    cfg.sep_backend = sep_backend
    paddle.set_device(dev)
    paddle.seed(SEED)
    model = LlamaForCausalLM(cfg)
    model.to(dtype="bfloat16")
    return model, cfg, b, s


def full_run(kind, dev, rank):
    """(b): ``bench.py``'s Llama under dp / mp / sharding = 2."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.distributed import Replicate, Shard, fleet, \
        shard_tensor
    from paddle_tpu_torch.distributed.sharding import group_sharded_parallel
    from paddle_tpu_torch.models.llama import shard_llama
    hcg = _hybrid(**{kind: 2})
    model, cfg, b, s = full_model(dev)
    ids = _ids(cfg.vocab_size, b, s, SEED)
    post = None
    if kind == "dp":
        # the batch split 4 / 4; fleet's optimizer averages the gradients
        ids = ids[rank * b // 2:(rank + 1) * b // 2]
        model = fleet.distributed_model(model)
        opt = fleet.distributed_optimizer(_adamw(model))

        def post():          # the averaged gradient's norm, after the step
            return grad_norm(model.parameters())
    elif kind == "mp":
        shard_llama(model, hcg.get_mesh(), fsdp_axis="dp", mp_axis="mp")
        opt = _adamw(model)
    else:
        opt = _adamw(model)
        model, opt = group_sharded_parallel(model, opt, level="p_g_os")
    x, y = paddle.to_tensor(ids[:, :-1]), paddle.to_tensor(ids[:, 1:])
    if kind == "mp":
        x = shard_tensor(x, hcg.get_mesh(), [Shard(0)])
    elif kind == "sharding":
        # ZeRO's ranks are data-parallel: the batch split 4 / 4 over them
        x = shard_tensor(x, hcg.get_mesh(), [Replicate(), Replicate(),
                                             Shard(0)])
    out = run_steps(model, opt, (x, y), FULL_STEPS, post=post)
    out["tokens_per_step"] = b * s
    out["layers"] = cfg.num_hidden_layers
    del model, opt
    _free()
    return out


# ---------------------------------------------------------------- (c) MoE
def moe_model(dev):
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.models.llama import LlamaForCausalLM
    cfg, b, s = moe_config()
    paddle.set_device(dev)
    paddle.seed(SEED + 3)
    model = LlamaForCausalLM(cfg)
    model.to(dtype="bfloat16")
    return model, cfg, b, s


def moe_run(dev, hcg=None):
    import paddle_tpu_torch as paddle
    model, cfg, b, s = moe_model(dev)
    n_params = sum(p.size for p in model.parameters())
    ids = _ids(cfg.vocab_size, b, s, SEED + 3)
    opt = _adamw(model)
    x, y = paddle.to_tensor(ids[:, :-1]), paddle.to_tensor(ids[:, 1:])
    out = run_steps(model, opt, (x, y), MOE_STEPS)
    out["tokens_per_step"] = b * s
    out["layers"] = cfg.num_hidden_layers
    out["params_this_rank"] = int(n_params)
    del model, opt
    _free()
    return out


# ------------------------------------------- (d) pipeline and the sep axis
PP_MICRO = 4                   # accumulate_steps of the pipeline runs
PP_STEPS = {"1F1B": 4, "VPP": 2, "ZB-H1": 2}
SEP_STEPS = 3                  # steps of each sep run
TWIN_STEPS = 4                 # steps of (d)'s twins (the first warms up)
PART_C = (4, 2, 1024)          # part C: microbatches, their batch, seq


class _NormOpt:
    """An optimizer that records ``norm()`` when it steps (the pipeline
    schedules step it themselves, after their backward)."""

    def __init__(self, inner, norm):
        self.inner, self.norm, self.norms = inner, norm, []

    def step(self):
        self.norms.append(self.norm())
        self.inner.step()

    def clear_grad(self):
        self.inner.clear_grad()


def _timed(step, steps, timed_from=1):
    """``steps`` calls of ``step()`` (it returns the loss Tensor), each
    synchronised and timed; the staged collectives a timed step, the
    launches and the peak memory."""
    losses, ms = [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    for i in range(steps):
        if i == timed_from:
            _reset_comm()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(float(step()))
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    comm = _comm_counts()
    n = max(steps - timed_from, 1)
    return {"losses": losses, "ms": ms,
            "peak_gb": torch.cuda.max_memory_allocated() / 2 ** 30,
            "comm_per_step": {k: [c / n, b / n] for k, (c, b) in comm.items()},
            "launches": _launches()}


def pp_run(kind, dev):
    """pp = 2 over the two ranks: ``_llama_child`` as
    ``LlamaForCausalLMPipe`` (tied embedding and head on stages 0 and 1)
    under 1F1B, the interleaved schedule (v = 2, one layer a chunk) or
    ZB-H1, ``accumulate_steps`` 4; ``tie_diff`` is the largest difference
    between the tied weight's copies after the steps."""
    import paddle_tpu_torch as paddle
    import torch.distributed as dist
    from paddle_tpu_torch.models.llama import LlamaForCausalLMPipe
    from paddle_tpu_torch.parallel import (PipelineParallel,
                                           PipelineParallelWithInterleave,
                                           ZeroBubblePipelineParallel)
    hcg = _hybrid(pp=2)
    cfg, b, s = full_config()
    paddle.set_device(dev)
    paddle.seed(SEED)
    pipe = LlamaForCausalLMPipe(cfg, num_stages=2,
                                num_virtual_pipeline_stages=2
                                if kind == "VPP" else None)
    pipe.to(dtype="bfloat16")

    class _S:
        pipeline_configs = {"accumulate_steps": PP_MICRO}
    cls = {"VPP": PipelineParallelWithInterleave,
           "ZB-H1": ZeroBubblePipelineParallel}.get(kind, PipelineParallel)
    model = cls(pipe, strategy=_S())
    group = hcg.get_pipe_parallel_group()

    def norm():
        sq = torch.zeros((), device=dev)
        for p in model.parameters():
            if p.grad is not None and id(p) not in pipe._replicas:
                sq = sq + torch.sum(torch.square(p.grad._buf.float()))
        dist.all_reduce(sq, group=group.pg)
        return float(sq) ** 0.5
    opt = _NormOpt(_adamw(model), norm)
    ids = _ids(cfg.vocab_size, b, s, SEED)
    x, y = paddle.to_tensor(ids[:, :-1]), paddle.to_tensor(ids[:, 1:])
    out = _timed(lambda: model.train_batch((x, y), opt), PP_STEPS[kind])
    tie = 0.0                  # the tied weight's two copies after the steps
    for g, params in pipe._shared_groups:
        for p in params:
            mine = p._buf.detach()
            first = mine.clone()
            dist.broadcast(first, g.ranks[0], group=g.pg)
            tie = max(tie, float((first.float() - mine.float()).abs().max()))
    out.update(norms=opt.norms, tokens_per_step=b * s, tie_diff=tie,
               layers=cfg.num_hidden_layers, in_flight=model.max_in_flight,
               params_this_rank=int(sum(p.size for p in model.parameters())))
    del model, pipe, opt
    _free()
    return out


def sep_run(backend, dev):
    """sep = 2: ``_llama_child`` with the batch's sequence split over the
    two ranks (q [8, 512, 16, 128] a rank), attention by ring or
    Ulysses."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.distributed import Replicate, Shard, shard_tensor
    hcg = _hybrid(sep=2)
    model, cfg, b, s = full_model(dev, sep_backend=backend)
    opt = _adamw(model)
    ids = _ids(cfg.vocab_size, b, s, SEED)
    x, y = paddle.to_tensor(ids[:, :-1]), paddle.to_tensor(ids[:, 1:])
    x = shard_tensor(x, hcg.get_mesh(), [Replicate()] * 3 + [Shard(1)])
    out = run_steps(model, opt, (x, y), SEP_STEPS)
    out["tokens_per_step"] = b * s
    out["layers"] = cfg.num_hidden_layers
    del model, opt
    _free()
    return out


def ring_check(dev):
    """The ring (K1-K3 a block) against its plain twin
    (``_ring_attn_local``, f32 online softmax) on this rank's block at the
    sep run's shapes, bf16: output and gradients, relative to the twin's
    largest magnitude; both timed, forward and backward."""
    from paddle_tpu_torch.parallel.ring_attention import (_Ring,
                                                          _ring_attn_local)
    hcg = _hybrid(sep=2)
    g = hcg.axis_group("sep")
    cfg, b, s = full_config()
    h, kv, d = cfg.num_attention_heads, cfg.num_key_value_heads, \
        cfg.hidden_size // cfg.num_attention_heads
    gen = torch.Generator(device=dev).manual_seed(SEED + 7 + g.get_rank())
    q, k, v, do = (torch.randn(b, s // 2, n, d, generator=gen, device=dev,
                               dtype=torch.bfloat16)
                   for n in (h, kv, kv, h))
    scale = d ** -0.5

    def run(fn):
        ts = [t.clone().requires_grad_(True) for t in (q, k, v)]
        o = fn(*ts)
        o.backward(do)
        return [o.detach()] + [t.grad for t in ts]

    kernel = lambda a, b_, c: _Ring.apply(a, b_, c, g, True, scale)  # noqa
    plain = lambda a, b_, c: _ring_attn_local(a, b_, c, "sep", True,  # noqa
                                              scale)
    _reset_launches()
    got, want = run(kernel), run(plain)
    launches = _launches()
    errs = [float((x.float() - w.float()).abs().max()
                  / w.float().abs().max()) for x, w in zip(got, want)]
    ms = {}
    for name, fn in (("kernel", kernel), ("plain", plain)):
        run(fn)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            run(fn)
        torch.cuda.synchronize()
        ms[name] = (time.perf_counter() - t0) * 1e3 / 3
    return {"errs": errs, "ms": ms, "launches": launches,
            "shape": [list(q.shape), list(k.shape)]}


def part_c_inputs(dev, cfg):
    """Dryrun part C at hidden 2048, f32: two stages of one decoder layer
    (``make_decoder_stage`` drawn from a seeded generator), M = 4
    microbatches."""
    from paddle_tpu_torch.models.llama import make_decoder_stage
    init, apply = make_decoder_stage(cfg)
    gen = torch.Generator(device=dev).manual_seed(SEED + 11)
    stages = [init(gen, device=dev) for _ in range(2)]
    stacked = {k: torch.stack([st[k] for st in stages]).requires_grad_(True)
               for k in stages[0]}
    m, b, s = PART_C
    xs = torch.randn(m, b, s, cfg.hidden_size, generator=gen, device=dev)
    return apply, stacked, xs


def part_c_run(dev, ranks):
    """The SPMD GPipe ``pipeline_forward`` over the two ranks (ranks) or the
    same stages in sequence in one process: sum(out ** 2), its gradient
    norm and time."""
    from paddle_tpu_torch.parallel import pipeline_forward
    cfg, _, _ = full_config()
    if ranks:
        hcg = _hybrid(pp=2)
    apply, stacked, xs = part_c_inputs(dev, cfg)
    _reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if ranks:
        out = pipeline_forward(apply, stacked, xs, axis_name="pp")
    else:
        outs = []
        for m in range(xs.shape[0]):
            hh = xs[m]
            for st in range(2):
                hh = apply({k: v[st] for k, v in stacked.items()}, hh)
            outs.append(hh)
        out = torch.stack(outs)
    loss = (out.float() ** 2).sum()
    loss.backward()
    sq = sum(torch.sum(v.grad.double() ** 2) for v in stacked.values())
    if ranks:
        import torch.distributed as dist
        dist.all_reduce(sq, group=hcg.get_pipe_parallel_group().pg)
    torch.cuda.synchronize()
    res = {"loss": float(loss), "norm": float(sq) ** 0.5,
           "ms": (time.perf_counter() - t0) * 1e3, "launches": _launches()}
    del stacked, xs, out
    _free()
    return res


def exchange_check(dev):
    """A 32 MB ring exchange between the two ranks over the CUDA backend
    (each sends before it receives): its time and whether it arrived."""
    from paddle_tpu_torch.distributed import collective as c
    hcg = _hybrid(sep=2)
    g = hcg.axis_group("sep")
    me = g.get_rank()
    a = torch.full((8 * 2 ** 20,), float(me + 1), device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = c._permute(a, g, ((0, 1), (1, 0)))
    torch.cuda.synchronize()
    return {"ok": bool((got == float(2 - me)).all()),
            "ms": (time.perf_counter() - t0) * 1e3}


def pp_sep_ranks(dev):
    out = {"exchange": exchange_check(dev), "ring_check": ring_check(dev)}
    for kind in ("1F1B", "VPP", "ZB-H1"):
        out[kind] = pp_run(kind, dev)
    for backend in ("ring", "ulysses"):
        out[backend] = sep_run(backend, dev)
    out["C"] = part_c_run(dev, True)
    return out


def micro_twin(dev):
    """The world-1 twin of the pipeline runs: ``_llama_child`` with the
    same 4 microbatches a step, gradients accumulated."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import ops
    model, cfg, b, s = full_model(dev)
    opt = _NormOpt(_adamw(model), lambda: grad_norm(model.parameters()))
    ids = _ids(cfg.vocab_size, b, s, SEED)
    x, y = paddle.to_tensor(ids[:, :-1]), paddle.to_tensor(ids[:, 1:])

    def step():
        total = None
        for xm, ym in zip(ops.split(x, PP_MICRO, axis=0),
                          ops.split(y, PP_MICRO, axis=0)):
            _, loss = model(xm, labels=ym)
            (loss / PP_MICRO).backward()
            d = (loss / PP_MICRO).detach()
            total = d if total is None else total + d
        opt.step()
        opt.clear_grad()
        return total
    out = _timed(step, TWIN_STEPS)
    out["norms"] = opt.norms
    out["tokens_per_step"] = b * s
    del model, opt
    _free()
    return out


def ranks_main(out_dir):
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch.distributed import env
    from paddle_tpu_torch.ops import _build
    env_ = dist.init_parallel_env()
    rank = env_.rank
    dev = env_.device
    backend, why = env.backend_choice()
    print(f"rank {rank} of {env_.world_size} on {dev}: backend {backend} "
          f"({why})", flush=True)
    _build.load("flash_attention")
    paddle.set_device(dev)
    t0 = time.time()
    res = {"rank": rank, "backend": backend, "why": why,
           "a": part_a(dev)}
    print(f"rank {rank}: (a) {time.time() - t0:.1f} s", flush=True)
    res["b"] = {}
    for kind in ("dp", "mp", "sharding"):
        t0 = time.time()
        res["b"][kind] = full_run(kind, dev, rank)
        print(f"rank {rank}: (b) {kind} {time.time() - t0:.1f} s: "
              f"losses {res['b'][kind]['losses']}", flush=True)
    t0 = time.time()
    _hybrid(ep=2)
    res["c"] = moe_run(dev)
    print(f"rank {rank}: (c) {time.time() - t0:.1f} s: losses "
          f"{res['c']['losses']} aux {res['c']['aux']}", flush=True)
    Path(out_dir, f"ranks.{rank}.json").write_text(json.dumps(res))
    dist.barrier()
    dist.destroy_process_group()
    return 0


def pp_sep_ranks_main(out_dir):
    """(d) on the two launched ranks: pp = 2 and sep = 2."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch.distributed import env
    from paddle_tpu_torch.ops import _build
    env_ = dist.init_parallel_env()
    rank, dev = env_.rank, env_.device
    backend, why = env.backend_choice()
    print(f"rank {rank} of {env_.world_size} on {dev}: backend {backend} "
          f"({why})", flush=True)
    _build.load("flash_attention")
    paddle.set_device(dev)
    t0 = time.time()
    res = {"rank": rank, "backend": backend, "d": pp_sep_ranks(dev)}
    print(f"rank {rank}: (d) {time.time() - t0:.1f} s", flush=True)
    Path(out_dir, f"pp_sep.{rank}.json").write_text(json.dumps(res))
    dist.barrier()
    dist.destroy_process_group()
    return 0


# ------------------------------------------------------------------ twins
def gpt2_run(dev, recompute):
    import paddle_tpu_torch as paddle
    import chip_smoke as cs
    from paddle_tpu_torch.models.gpt2 import GPT2ForCausalLM
    cfg, b, s = cs.gpt2_bench_config()
    cfg.use_recompute = recompute
    paddle.set_device(dev)
    paddle.seed(SEED)
    model = GPT2ForCausalLM(cfg)
    model.to(dtype="bfloat16")
    model.train()
    opt = _adamw(model)
    ids = _ids(cfg.vocab_size, b, s, SEED)
    x, y = paddle.to_tensor(ids[:, :-1]), paddle.to_tensor(ids[:, 1:])
    grads = {}

    def keep():
        for n, p in model.named_parameters():
            if p.grad is not None and n not in grads:
                grads[n] = p.grad._buf.detach().clone()
        return grad_norm(model.parameters())
    out = run_steps(model, opt, (x, y), GPT2_STEPS, post=keep)
    del model, opt
    _free()
    return out, grads


def twin_main(out_dir):
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch.distributed import env
    from paddle_tpu_torch.ops import _build
    _hybrid()              # every degree 1: one rank, NCCL at world size 1
    backend, why = env.backend_choice()
    import torch.distributed as tdist
    print(f"twin: world {tdist.get_world_size()}, backend "
          f"{tdist.get_backend()} ({why})", flush=True)
    dev = env._env().device
    _build.load("flash_attention")
    paddle.set_device(dev)
    res = {"backend": tdist.get_backend(), "why": why}
    t0 = time.time()
    model, cfg, b, s = full_model(dev)
    ids = _ids(cfg.vocab_size, b, s, SEED)
    x, y = paddle.to_tensor(ids[:, :-1]), paddle.to_tensor(ids[:, 1:])
    opt = _adamw(model)
    res["b"] = run_steps(model, opt, (x, y), FULL_STEPS)
    res["b"]["tokens_per_step"] = b * s
    res["b"]["layers"] = cfg.num_hidden_layers
    del model, opt
    _free()
    print(f"twin: (b) {time.time() - t0:.1f} s: losses {res['b']['losses']}",
          flush=True)
    t0 = time.time()
    res["c"] = moe_run(dev)
    print(f"twin: (c) {time.time() - t0:.1f} s: losses {res['c']['losses']} "
          f"aux {res['c']['aux']}", flush=True)
    t0 = time.time()
    plain, g_plain = gpt2_run(dev, False)
    remat, g_remat = gpt2_run(dev, True)
    diffs = {n: float((g_remat[n].float() - g_plain[n].float()).abs().max()
                      / g_plain[n].float().abs().max().clamp(min=1e-30))
             for n in g_plain}
    res["recompute"] = {
        "plain": plain, "recompute": remat,
        "bitwise": all(torch.equal(g_remat[n], g_plain[n]) for n in g_plain)
        and plain["losses"] == remat["losses"],
        "worst_grad_rel": max(diffs.values()), "params": len(diffs)}
    print(f"twin: recompute {time.time() - t0:.1f} s: bitwise "
          f"{res['recompute']['bitwise']}", flush=True)
    Path(out_dir, "twin.json").write_text(json.dumps(res))
    dist.destroy_process_group()
    return 0


def pp_sep_twin_main(out_dir):
    """(d)'s world-1 twins: the microbatched step of the pipeline runs,
    the full-batch step of the sep runs and part C's stages in
    sequence."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch.distributed import env
    from paddle_tpu_torch.ops import _build
    _hybrid()
    import torch.distributed as tdist
    dev = env._env().device
    _build.load("flash_attention")
    paddle.set_device(dev)
    t0 = time.time()
    model, cfg, b, s = full_model(dev)
    ids = _ids(cfg.vocab_size, b, s, SEED)
    x, y = paddle.to_tensor(ids[:, :-1]), paddle.to_tensor(ids[:, 1:])
    opt = _adamw(model)
    res = {"backend": tdist.get_backend(),
           "full": run_steps(model, opt, (x, y), TWIN_STEPS)}
    res["full"]["tokens_per_step"] = b * s
    del model, opt
    _free()
    res["micro"] = micro_twin(dev)
    res["C"] = part_c_run(dev, False)
    print(f"pp/sep twin: {time.time() - t0:.1f} s", flush=True)
    Path(out_dir, "pp_sep_twin.json").write_text(json.dumps(res))
    dist.destroy_process_group()
    return 0


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--ranks", action="store_true")
    ap.add_argument("--twin", action="store_true")
    ap.add_argument("--pp-sep-ranks", action="store_true")
    ap.add_argument("--pp-sep-twin", action="store_true")
    ap.add_argument("--phase", choices=("hybrid", "pipeline_sep", "both"),
                    default="both")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("hybrid_phase: CUDA is not available", file=sys.stderr)
        return 2
    if args.ranks:
        return ranks_main(args.out)
    if args.twin:
        return twin_main(args.out)
    if args.pp_sep_ranks:
        return pp_sep_ranks_main(args.out)
    if args.pp_sep_twin:
        return pp_sep_twin_main(args.out)
    import chip_smoke as cs
    from paddle_tpu_torch.distributed import staged
    from paddle_tpu_torch.ops import _build
    print(sys.version, torch.__version__, torch.version.cuda, flush=True)
    card = cs.card_line()
    print("card:", card, flush=True)
    t0 = time.time()
    _build.load("flash_attention")
    staged.load()
    print(f"build flash_attention + staged backend {time.time() - t0:.1f} s",
          flush=True)
    if args.phase in ("hybrid", "both"):
        t0 = time.time()
        out = cs.hybrid_phase(torch.device("cuda", 0), card)
        print(f"hybrid phase {time.time() - t0:.1f} s: {json.dumps(out)}",
              flush=True)
    if args.phase in ("pipeline_sep", "both"):
        t0 = time.time()
        out = cs.pipeline_sep_phase(torch.device("cuda", 0), card)
        print(f"pipeline_sep phase {time.time() - t0:.1f} s: "
              f"{json.dumps(out)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
