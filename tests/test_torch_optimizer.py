"""The port's Adam / AdamW and gradient clipping against the JAX
package's, on numpy parameter and gradient streams on the CPU.

Both sides get the same parameters (named ``w0``, ``w1``, ... on the JAX
side, passed as ``named_parameters``-style pairs to the port) and the same
gradient at every step.  float32 parameters are held at rtol 1e-6 / atol
1e-6: the same float32 arithmetic, but XLA's sqrt and divide round
otherwise, which moves each step (of size lr = 0.01) by up to about 1e-5
of itself.  bfloat16 parameters at one bf16 ulp (a float32 difference at a
rounding boundary flips it)."""
import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu.nn as jnn
from paddle_tpu.optimizer import Adam as JAdam
from paddle_tpu.optimizer import AdamW as JAdamW
from paddle_tpu.optimizer import L1Decay as JL1
from paddle_tpu.optimizer import L2Decay as JL2
from paddle_tpu_torch.nn import (ClipGradByGlobalNorm, ClipGradByNorm,
                                 ClipGradByValue)
from paddle_tpu_torch.optimizer import Adam, AdamW, L1Decay, L2Decay

SHAPES = [(8, 6), (6,), (3, 4, 2)]


def _streams(seed, steps=4):
    rng = np.random.RandomState(seed)
    init = [rng.randn(*s).astype(np.float32) for s in SHAPES]
    grads = [[(rng.randn(*s) * 10 ** rng.uniform(-3, 0)).astype(np.float32)
              for s in SHAPES] for _ in range(steps)]
    return init, grads


def _pair(init, dtype):
    jp = [pt.Parameter(a, name=f"w{i}") for i, a in enumerate(init)]
    tp = [torch.nn.Parameter(torch.from_numpy(a.copy())) for a in init]
    if dtype == "bfloat16":
        for p in jp:
            p._data = p._data.astype("bfloat16")
        tp = [torch.nn.Parameter(p.detach().to(torch.bfloat16)) for p in tp]
    return jp, tp


def _feed(jp, tp, grads, dtype):
    for p, g in zip(jp, grads):
        p.grad = pt.to_tensor(g).astype(dtype)
    for p, g in zip(tp, grads):
        p.grad = torch.from_numpy(g).to(p.dtype)


def _same(jp, tp, dtype):
    for i, (a, b) in enumerate(zip(jp, tp)):
        want = np.asarray(a.astype("float32").numpy())
        got = b.detach().float().numpy()
        if dtype == "float32":
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6,
                                       err_msg=f"w{i}")
        else:
            np.testing.assert_allclose(got, want, rtol=2 ** -7, atol=1e-7,
                                       err_msg=f"w{i}")


def _decay_w1(name):
    return name != "w1"


CASES = {
    "adam": (JAdam, Adam, {}),
    "adam_l2": (JAdam, Adam, {"weight_decay": "l2"}),
    "adam_l1_amsgrad": (JAdam, Adam, {"weight_decay": "l1", "amsgrad": True}),
    "adamw": (JAdamW, AdamW, {"weight_decay": 0.05}),
    "adamw_decay_fun": (JAdamW, AdamW, {"weight_decay": 0.05,
                                        "apply_decay_param_fun": _decay_w1}),
    "adamw_clip": (JAdamW, AdamW, {"weight_decay": 0.01, "clip": True}),
}


@pytest.mark.parametrize("multi_precision", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_update_matches_jax(case, dtype, multi_precision):
    jcls, tcls, kw = CASES[case]
    init, grads = _streams(len(case) + len(dtype))
    jp, tp = _pair(init, dtype)
    jkw, tkw = dict(kw), dict(kw)
    if kw.get("weight_decay") == "l2":
        jkw["weight_decay"], tkw["weight_decay"] = JL2(0.1), L2Decay(0.1)
    if kw.get("weight_decay") == "l1":
        jkw["weight_decay"], tkw["weight_decay"] = JL1(0.1), L1Decay(0.1)
    tkw.pop("clip", None)
    if jkw.pop("clip", False):
        jkw["grad_clip"] = jnn.ClipGradByGlobalNorm(0.5)
        tkw["grad_clip"] = ClipGradByGlobalNorm(0.5)
    jopt = jcls(learning_rate=0.01, parameters=jp,
                multi_precision=multi_precision, **jkw)
    topt = tcls(learning_rate=0.01,
                parameters=[(f"w{i}", p) for i, p in enumerate(tp)],
                multi_precision=multi_precision, **tkw)
    for g in grads:
        _feed(jp, tp, g, dtype)
        jopt.step()
        topt.step()
        jopt.clear_grad()
        topt.clear_grad()
        _same(jp, tp, dtype)
    assert all(p.grad is None for p in tp)
    for name, store in topt._accumulators.items():
        if name.startswith("moment") or name == "master_weight":
            assert all(t.dtype == torch.float32 for t in store.values())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_state_dict_round_trip_resumes_the_same_run(dtype):
    """Two steps, state_dict into a fresh optimizer (with a fresh copy of
    the parameters), two more steps: the same as four uninterrupted steps
    and as the JAX run; the saved float32 moments stay float32."""
    init, grads = _streams(11)
    jp, tp = _pair(init, dtype)
    jopt = JAdamW(learning_rate=0.01, parameters=jp, weight_decay=0.02)
    topt = AdamW(learning_rate=0.01, parameters=tp, weight_decay=0.02)
    for g in grads[:2]:
        _feed(jp, tp, g, dtype)
        jopt.step()
        topt.step()
    sd = {k: v.clone() for k, v in topt.state_dict().items()}
    assert sd["moment1_0"].dtype == torch.float32
    assert int(sd["global_step"]) == 2
    tp2 = [torch.nn.Parameter(p.detach().clone()) for p in tp]
    topt2 = AdamW(learning_rate=0.01, parameters=tp2, weight_decay=0.02)
    topt2.set_state_dict(sd)
    assert topt2._global_step == 2
    for g in grads[2:]:
        _feed(jp, tp, g, dtype)
        _feed(jp, tp2, g, dtype)
        jopt.step()
        topt.step()
        topt2.step()
    _same(jp, tp2, dtype)
    for a, b in zip(tp, tp2):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    # keys name the accumulator and the parameter's index, as the
    # reference's do
    assert set(jopt.state_dict()) == set(topt2.state_dict())


def test_lr_get_set_and_refused_scheduler():
    p = torch.nn.Parameter(torch.ones(2))
    opt = AdamW(learning_rate=0.1, parameters=[p])
    assert opt.get_lr() == 0.1
    opt.set_lr(0.02)
    assert opt.get_lr() == 0.02
    with pytest.raises(NotImplementedError, match="schedulers"):
        AdamW(learning_rate=lambda: 0.1, parameters=[p])


@pytest.mark.parametrize("clip", ["global", "norm", "value"])
def test_clippers_match_jax(clip):
    rng = np.random.RandomState(9)
    gs = [rng.randn(*s).astype(np.float32) * 3 for s in SHAPES]
    jc, tc = {"global": (jnn.ClipGradByGlobalNorm(1.0),
                         ClipGradByGlobalNorm(1.0)),
              "norm": (jnn.ClipGradByNorm(1.5), ClipGradByNorm(1.5)),
              "value": (jnn.ClipGradByValue(0.7), ClipGradByValue(0.7))}[clip]
    jp = [pt.Parameter(np.zeros_like(g)) for g in gs]
    tp = [torch.nn.Parameter(torch.zeros(g.shape)) for g in gs]
    jp[1].need_clip = False
    tp[1].need_clip = False
    want = jc([(p, pt.to_tensor(g)) for p, g in zip(jp, gs)])
    got = tc([(p, torch.from_numpy(g)) for p, g in zip(tp, gs)])
    for (_, a), (_, b) in zip(want, got):
        np.testing.assert_allclose(b.numpy(), np.asarray(a.numpy()),
                                   rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(got[1][1].numpy(), gs[1])
