"""The port's optimizers, learning-rate schedulers and gradient clipping
against the JAX package's, on numpy parameter and gradient streams on the
CPU.

The first tests run Adam / AdamW on ``torch.nn.Parameter``s (the
``torch.nn`` models' path); the later ones every optimizer class on port
``Parameter``s, every scheduler, and ``tests/test_optimizer.py``'s cases.

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


@pytest.mark.parametrize("lr", ["number", "scheduler"])
def test_lr_get_set_and_refused_scheduler(lr):
    """A number: get_lr / set_lr, and set_lr fills the 0-d float32
    learning-rate tensor in place.  A scheduler: it drives get_lr and the
    tensor, and set_lr is refused."""
    from paddle_tpu_torch.optimizer.lr import StepDecay
    p = torch.nn.Parameter(torch.ones(2))
    if lr == "number":
        opt = AdamW(learning_rate=0.1, parameters=[p])
        buf = opt._lr_t._data
        assert opt.get_lr() == 0.1
        opt.set_lr(0.02)
        assert opt.get_lr() == 0.02
        assert opt._lr_t._data is buf and buf.item() == np.float32(0.02)
        return
    sched = StepDecay(0.1, step_size=1, gamma=0.5)
    opt = AdamW(learning_rate=sched, parameters=[p])
    assert opt.get_lr() == 0.1 and opt._lr_t.item() == np.float32(0.1)
    sched.step()
    assert opt.get_lr() == 0.05 and opt._lr_t.item() == np.float32(0.05)
    with pytest.raises(RuntimeError, match="LRScheduler"):
        opt.set_lr(0.3)


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


# --------------------------------------------- every class on port Parameters
import paddle_tpu_torch as tp  # noqa: E402
from paddle_tpu.optimizer import lr as jlr  # noqa: E402
from paddle_tpu_torch.core import device as tdevice  # noqa: E402
from paddle_tpu_torch.optimizer import lr as tlr  # noqa: E402


@pytest.fixture
def on_cpu():
    prev = tdevice._current_device
    tp.set_device("cpu")
    yield
    tdevice._current_device = prev


# class -> (kwargs, steps, takes multi_precision)
ALL = {
    "SGD": ({"learning_rate": 0.1, "weight_decay": "l2"}, 4, True),
    "Momentum": ({"learning_rate": 0.05, "momentum": 0.9}, 4, True),
    "Momentum_nesterov": ({"learning_rate": 0.05, "momentum": 0.8,
                           "use_nesterov": True, "weight_decay": "l1"}, 4, True),
    "Adam": ({"learning_rate": 0.01, "weight_decay": "l2"}, 4, True),
    "Adam_amsgrad": ({"learning_rate": 0.01, "amsgrad": True}, 4, True),
    "AdamW": ({"learning_rate": 0.01, "weight_decay": 0.05}, 4, True),
    "Adamax": ({"learning_rate": 0.01}, 4, False),
    "Adagrad": ({"learning_rate": 0.1, "initial_accumulator_value": 0.1}, 4,
                False),
    "RMSProp": ({"learning_rate": 0.01, "momentum": 0.5}, 4, False),
    "RMSProp_centered": ({"learning_rate": 0.01, "centered": True}, 4, False),
    "Adadelta": ({"learning_rate": 1.0}, 4, False),
    "Lamb": ({"learning_rate": 0.01, "lamb_weight_decay": 0.02}, 4, True),
    "LBFGS": ({"learning_rate": 0.2, "history_size": 3}, 5, False),
    "NAdam": ({"learning_rate": 0.01}, 4, False),
    "RAdam": ({"learning_rate": 0.01}, 8, False),
    "Rprop": ({"learning_rate": 0.01}, 5, False),
    "ASGD": ({"learning_rate": 0.1, "batch_num": 2}, 4, False),
}
ALL_CASES = [(c, d, mp) for c in sorted(ALL)
             for d in ("float32", "bfloat16")
             for mp in ((False, True) if ALL[c][2] else (False,))]


def _both_params(init, dtype):
    jp = [pt.Parameter(a, name=f"w{i}") for i, a in enumerate(init)]
    tpar = [tp.Parameter(a, name=f"w{i}") for i, a in enumerate(init)]
    if dtype == "bfloat16":
        for p in jp:
            p._data = p._data.astype("bfloat16")
        for p in tpar:
            p._data = p._data.detach().to(torch.bfloat16)
    return jp, tpar


@pytest.mark.parametrize("case,dtype,multi_precision", ALL_CASES)
def test_every_optimizer_on_parameters_matches_jax(on_cpu, case, dtype,
                                                   multi_precision):
    """Each class of the reference's ``optimizers.py`` on port
    ``Parameter``s: the same float32 / bf16 weights and gradient streams
    as the JAX optimizer, several steps, the parameters held after each
    (float32 at rtol 1e-5 / atol 1e-6, bf16 at one bf16 ulp); the
    parameter stays the same trainable leaf, updated in place."""
    kw, steps, _ = ALL[case]
    cls = case.split("_")[0]
    init, grads = _streams(len(case) * 7 + len(dtype), steps)
    jp, tpar = _both_params(init, dtype)
    jkw, tkw = dict(kw), dict(kw)
    for k, (jd, td) in (("l2", (JL2, L2Decay)), ("l1", (JL1, L1Decay))):
        if kw.get("weight_decay") == k:
            jkw["weight_decay"], tkw["weight_decay"] = jd(0.1), td(0.1)
    if multi_precision:
        jkw["multi_precision"] = tkw["multi_precision"] = True
    jopt = getattr(pt.optimizer, cls)(parameters=jp, **jkw)
    topt = getattr(tp.optimizer, cls)(parameters=tpar, **tkw)
    bufs = [p._buf for p in tpar]
    for i, g in enumerate(grads):
        for p, a in zip(jp, g):
            p.grad = pt.to_tensor(a).astype(dtype)
        for p, a in zip(tpar, g):
            p.grad = tp.to_tensor(a).astype(dtype)
        jopt.step()
        topt.step()
        jopt.clear_grad()
        topt.clear_grad()
        for k, (a, b) in enumerate(zip(jp, tpar)):
            want = np.asarray(a.astype("float32").numpy())
            got = b.astype("float32").numpy()
            if dtype == "float32":
                np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6,
                                           err_msg=f"w{k}, step {i}")
            else:
                np.testing.assert_allclose(got, want, rtol=2 ** -7, atol=1e-7,
                                           err_msg=f"w{k}, step {i}")
    assert all(p._buf is b and p.is_leaf and not p.stop_gradient
               and p.grad is None for p, b in zip(tpar, bufs))
    if cls != "LBFGS":
        assert int(topt._global_step) == steps
        for store in topt._accumulators.values():
            assert all(t.dtype in (torch.float32, torch.int32)
                       for t in store.values())


def test_group_rates_decay_and_parameter_rates_match_jax(on_cpu):
    """Parameter groups with their own rate multiplier and weight decay,
    and a Parameter's ``optimize_attr["learning_rate"]``, under AdamW with
    ``apply_decay_param_fun`` and SGD."""
    init, grads = _streams(21)
    for name, cls, kw in (
            ("AdamW", "AdamW", {"weight_decay": 0.1,
                                "apply_decay_param_fun": lambda n: n != "w2"}),
            ("SGD", "SGD", {"weight_decay": 0.01})):
        jp, tpar = _both_params(init, "float32")
        for ps in (jp, tpar):
            ps[1].optimize_attr["learning_rate"] = 0.5
        groups = lambda ps: [{"params": ps[:2]},  # noqa: E731
                             {"params": ps[2:], "learning_rate": 0.3,
                              "weight_decay": 0.0}]
        jopt = getattr(pt.optimizer, cls)(learning_rate=0.02,
                                          parameters=groups(jp), **kw)
        topt = getattr(tp.optimizer, cls)(learning_rate=0.02,
                                          parameters=groups(tpar), **kw)
        for g in grads:
            for p, a in zip(jp, g):
                p.grad = pt.to_tensor(a)
            for p, a in zip(tpar, g):
                p.grad = tp.to_tensor(a)
            jopt.step()
            topt.step()
            for a, b in zip(jp, tpar):
                np.testing.assert_allclose(b.numpy(), np.asarray(a.numpy()),
                                           rtol=1e-5, atol=1e-6, err_msg=name)


# ------------------------------------------------------------- schedulers
SCHEDULERS = {
    "NoamDecay": ((), {"d_model": 64, "warmup_steps": 4}),
    "PiecewiseDecay": (([3, 6], [0.1, 0.05, 0.01]), {}),
    "NaturalExpDecay": ((0.5,), {"gamma": 0.1}),
    "InverseTimeDecay": ((0.5,), {"gamma": 0.2}),
    "PolynomialDecay": ((0.5,), {"decay_steps": 5, "power": 2.0}),
    "PolynomialDecay_cycle": ((0.5,), {"decay_steps": 4, "cycle": True}),
    "LinearWarmup": ((0.3,), {"warmup_steps": 3, "start_lr": 0.0,
                              "end_lr": 0.3}),
    "LinearWarmup_inner": (("StepDecay",), {"warmup_steps": 3,
                                            "start_lr": 0.01, "end_lr": 0.5}),
    "ExponentialDecay": ((0.5,), {"gamma": 0.8}),
    "MultiStepDecay": ((0.5,), {"milestones": [2, 5], "gamma": 0.3}),
    "StepDecay": ((0.5,), {"step_size": 3, "gamma": 0.5}),
    "LambdaDecay": ((0.5,), {"lr_lambda": lambda e: 0.9 ** e}),
    "MultiplicativeDecay": ((0.5,), {"lr_lambda": lambda e: 0.95}),
    "ReduceOnPlateau": ((1.0,), {"patience": 1, "factor": 0.5}),
    "CosineAnnealingDecay": ((0.5,), {"T_max": 7, "eta_min": 0.01}),
    "CosineAnnealingWarmRestarts": ((0.5,), {"T_0": 3, "T_mult": 2}),
    "OneCycleLR": ((1.0,), {"total_steps": 10}),
    "OneCycleLR_linear": ((1.0,), {"total_steps": 10,
                                   "anneal_strategy": "linear"}),
    "CyclicLR": ((0.1, 1.0), {"step_size_up": 3}),
    "CyclicLR_triangular2": ((0.1, 1.0), {"step_size_up": 2,
                                          "step_size_down": 3,
                                          "mode": "triangular2"}),
    "CyclicLR_exp_range": ((0.1, 1.0), {"step_size_up": 2,
                                        "mode": "exp_range",
                                        "exp_gamma": 0.9}),
    "LinearLR": ((0.5,), {"total_steps": 6, "start_factor": 0.2}),
    "CosineAnnealingWithWarmupDecay": ((), {"max_lr": 1.0, "min_lr": 0.1,
                                            "warmup_step": 3,
                                            "decay_step": 9}),
}


def _scheduler(mod, case):
    args, kw = SCHEDULERS[case]
    if args and args[0] == "StepDecay":
        args = (mod.StepDecay(0.5, step_size=2),)
    return getattr(mod, case.split("_")[0])(*args, **kw)


@pytest.mark.parametrize("case", sorted(SCHEDULERS))
def test_scheduler_sequence_matches_jax_and_drives_the_lr_tensor(on_cpu, case):
    """Twelve steps of each scheduler against the reference's, and the bound
    optimizer's learning-rate tensor filled in place with each value."""
    js, ts = _scheduler(jlr, case), _scheduler(tlr, case)
    p = tp.Parameter(np.ones(2, np.float32))
    opt = tp.optimizer.SGD(learning_rate=ts, parameters=[p])
    buf = opt._lr_t._data
    metrics = [1.0, 0.9, 0.95, 0.95, 0.96, 0.97, 0.5, 0.5, 0.6, 0.7, 0.8, 0.9]
    for i in range(12):
        assert ts() == js(), (case, i)
        assert opt.get_lr() == float(js())
        assert buf.item() == np.float32(js()) and opt._lr_t._data is buf
        if case == "ReduceOnPlateau":
            js.step(metrics[i])
            ts.step(metrics[i])
        else:
            js.step()
            ts.step()
    # the reference's state_dict keeps every list attribute, the bound
    # optimizers too
    assert ({k: v for k, v in ts.state_dict().items() if k != "_bound_opts"}
            == js.state_dict())


def test_scheduler_optimizer_state_dict_round_trip_resumes_the_run(on_cpu):
    """Momentum under a StepDecay for three steps, then its state_dict (the
    scheduler's included) into a fresh optimizer and scheduler over copies
    of the parameters: the next three steps are the uninterrupted JAX
    run's.  The restored scheduler stays bound to its own optimizer and the
    rate tensor takes the restored rate at once (the reference's
    ``set_state_dict`` leaves both to the saving run: ROADMAP queue 3)."""
    init, grads = _streams(31, steps=6)
    jp, tpar = _both_params(init, "float32")
    js, ts = jlr.StepDecay(0.1, step_size=2, gamma=0.5), \
        tlr.StepDecay(0.1, step_size=2, gamma=0.5)
    jopt = pt.optimizer.Momentum(learning_rate=js, parameters=jp)
    topt = tp.optimizer.Momentum(learning_rate=ts, parameters=tpar)

    def run(opt, sched, ps, pkg, gs):
        for g in gs:
            for p, a in zip(ps, g):
                p.grad = pkg.to_tensor(a)
            opt.step()
            opt.clear_grad()
            sched.step()
    run(jopt, js, jp, pt, grads[:3])
    run(topt, ts, tpar, tp, grads[:3])
    sd = topt.state_dict()
    assert set(sd) == set(jopt.state_dict())
    t2 = [tp.Parameter(p.numpy()) for p in tpar]
    s2 = tlr.StepDecay(0.7, step_size=5)
    o2 = tp.optimizer.Momentum(learning_rate=s2, parameters=t2)
    o2.set_state_dict(sd)
    assert s2() == ts() and o2.get_lr() == topt.get_lr()
    assert o2._lr_t.item() == topt._lr_t.item() == np.float32(ts())
    # the scheduler's step writes the rate the run resumes with
    run(jopt, js, jp, pt, grads[3:])
    run(o2, s2, t2, tp, grads[3:])
    for a, b in zip(jp, t2):
        np.testing.assert_allclose(b.numpy(), np.asarray(a.numpy()),
                                   rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
def test_lr_and_beta_powers_live_on_the_card():
    """On a CUDA Parameter the learning rate, the step count and each beta
    power are device tensors, advanced there (no host copy a step)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda", 0)
    p = tp.Parameter(torch.ones(4, device=dev))
    opt = tp.optimizer.AdamW(learning_rate=0.1, parameters=[p])
    p.grad = tp.Tensor(torch.full((4,), 0.5, device=dev))
    opt.step()
    opt.step()
    assert opt._lr_t._data.device == dev and opt._lr_t.dtype == torch.float32
    assert opt._global_step._data.device == dev
    for name in ("beta1_pow", "beta2_pow", "moment1", "moment2"):
        t = opt._accumulators[name][id(p)]._data
        assert t.device == dev and t.dtype == torch.float32
    b1 = opt._accumulators["beta1_pow"][id(p)]._data
    assert b1.item() == pytest.approx(0.81, rel=1e-6)


# ------------------------------------------ tests/test_optimizer.py, ported
def _quadratic_problem():
    # minimize ||Wx - y||^2 over W
    rng = np.random.RandomState(0)
    x = tp.to_tensor(rng.rand(16, 4).astype(np.float32))
    y = tp.to_tensor(rng.rand(16, 2).astype(np.float32))
    w = tp.Parameter(np.zeros((4, 2), np.float32))
    return x, y, w


@pytest.mark.parametrize("opt_cls,kw", [
    ("SGD", dict(learning_rate=0.3)),
    ("Momentum", dict(learning_rate=0.1, momentum=0.9)),
    ("Adam", dict(learning_rate=0.1)),
    ("AdamW", dict(learning_rate=0.1, weight_decay=0.0)),
    ("RMSProp", dict(learning_rate=0.05)),
    ("Adagrad", dict(learning_rate=0.5)),
    ("Lamb", dict(learning_rate=0.05, lamb_weight_decay=0.0)),
])
def test_optimizers_converge(on_cpu, opt_cls, kw):
    x, y, w = _quadratic_problem()
    opt = getattr(tp.optimizer, opt_cls)(parameters=[w], **kw)
    first = last = None
    for i in range(60):
        loss = ((x @ w - y) ** 2).mean()
        loss.backward()
        opt.step()
        opt.clear_grad()
        if i == 0:
            first = loss.item()
        last = loss.item()
    # the problem has ~0.27x irreducible least-squares floor
    assert last < first * 0.35, f"{opt_cls}: {first} -> {last}"


def test_sgd_exact_update(on_cpu):
    w = tp.Parameter(np.array([1.0, 2.0], np.float32))
    opt = tp.optimizer.SGD(learning_rate=0.1, parameters=[w])
    (w * w).sum().backward()  # grad = 2w
    opt.step()
    np.testing.assert_allclose(w.numpy(), [1.0 - 0.2, 2.0 - 0.4], rtol=1e-5)


def test_adamw_decoupled_decay(on_cpu):
    w = tp.Parameter(np.array([10.0], np.float32))
    opt = tp.optimizer.AdamW(learning_rate=0.1, weight_decay=0.5, parameters=[w])
    w.sum().backward()
    opt.step()
    # decoupled: w <- w*(1 - lr*wd) - lr * update(~1 at t=0)
    expected = 10.0 * (1 - 0.1 * 0.5) - 0.1
    np.testing.assert_allclose(w.numpy(), [expected], rtol=1e-3)


def test_optimizer_state_dict_roundtrip(on_cpu):
    x, y, w = _quadratic_problem()
    opt = tp.optimizer.Adam(learning_rate=0.1, parameters=[w])
    ((x @ w - y) ** 2).mean().backward()
    opt.step()
    opt.clear_grad()
    sd = opt.state_dict()
    w2 = tp.Parameter(np.zeros((4, 2), np.float32))
    opt2 = tp.optimizer.Adam(learning_rate=0.1, parameters=[w2])
    ((x @ w2 - y) ** 2).mean().backward()
    opt2.step()
    opt2.clear_grad()
    opt2.set_state_dict(sd)
    np.testing.assert_allclose(opt2._acc("moment1", w2).numpy(),
                               opt._acc("moment1", w).numpy(), rtol=1e-6)


def test_param_groups_with_different_lr(on_cpu):
    w1 = tp.Parameter(np.array([1.0], np.float32))
    w2 = tp.Parameter(np.array([1.0], np.float32))
    opt = tp.optimizer.SGD(learning_rate=0.1,
                           parameters=[{"params": [w1]},
                                       {"params": [w2], "learning_rate": 0.5}])
    (w1 + w2).backward()
    opt.step()
    np.testing.assert_allclose(w1.numpy(), [0.9], rtol=1e-5)
    np.testing.assert_allclose(w2.numpy(), [0.95], rtol=1e-5)


def test_grad_clip_global_norm(on_cpu):
    w = tp.Parameter(np.array([3.0, 4.0], np.float32))  # |g|=10 after *2
    opt = tp.optimizer.SGD(learning_rate=1.0, parameters=[w],
                           grad_clip=ClipGradByGlobalNorm(1.0))
    (w * w).sum().backward()  # grad [6, 8], norm 10
    opt.step()
    # clipped grad = [0.6, 0.8]
    np.testing.assert_allclose(w.numpy(), [3.0 - 0.6, 4.0 - 0.8], rtol=1e-4)


def test_grad_clip_by_value(on_cpu):
    w = tp.Parameter(np.array([3.0], np.float32))
    opt = tp.optimizer.SGD(learning_rate=1.0, parameters=[w],
                           grad_clip=ClipGradByValue(1.0))
    (w * 5).sum().backward()  # grad 5 -> clip to 1
    opt.step()
    np.testing.assert_allclose(w.numpy(), [2.0], rtol=1e-5)


class TestLRSchedulers:
    def test_step_decay(self):
        s = tlr.StepDecay(0.1, step_size=2, gamma=0.5)
        lrs = []
        for _ in range(5):
            lrs.append(s())
            s.step()
        np.testing.assert_allclose(lrs, [0.1, 0.1, 0.05, 0.05, 0.025], rtol=1e-6)

    def test_cosine(self):
        s = tlr.CosineAnnealingDecay(1.0, T_max=10)
        assert abs(s() - 1.0) < 1e-6
        for _ in range(10):
            s.step()
        assert s() < 1e-6

    def test_warmup_then_constant(self):
        s = tlr.LinearWarmup(0.1, warmup_steps=4, start_lr=0.0, end_lr=0.1)
        vals = []
        for _ in range(6):
            vals.append(s())
            s.step()
        np.testing.assert_allclose(vals[:4], [0.0, 0.025, 0.05, 0.075], rtol=1e-5)
        assert vals[5] == pytest.approx(0.1)

    def test_scheduler_with_optimizer(self, on_cpu):
        w = tp.Parameter(np.array([1.0], np.float32))
        sched = tlr.StepDecay(0.1, step_size=1, gamma=0.1)
        opt = tp.optimizer.SGD(learning_rate=sched, parameters=[w])
        w.sum().backward()
        opt.step()  # lr 0.1
        np.testing.assert_allclose(w.numpy(), [0.9], rtol=1e-5)
        sched.step()
        w.clear_grad()
        w.sum().backward()
        opt.step()  # lr 0.01
        np.testing.assert_allclose(w.numpy(), [0.89], rtol=1e-4)

    def test_cosine_warmup_decay_nlp(self):
        s = tlr.CosineAnnealingWithWarmupDecay(max_lr=1.0, min_lr=0.1,
                                               warmup_step=2, decay_step=10)
        s.step(1)
        assert s() == pytest.approx(0.5)
        s.step(10)
        assert s() == pytest.approx(0.1, abs=1e-6)

    def test_reduce_on_plateau(self):
        s = tlr.ReduceOnPlateau(1.0, patience=1, factor=0.5)
        for m in [1.0, 1.0, 1.0, 1.0]:
            s.step(m)
        assert s() < 1.0


class TestMasterWeights:
    """multi_precision keeps a persistent f32 master copy."""

    def test_sub_ulp_updates_accumulate(self, on_cpu):
        # bf16 ulp near 1.0 is ~0.0078; 200 updates of 1e-4 only land if the
        # master f32 copy persists between steps
        p = tp.Parameter(np.ones((8,), np.float32))
        p._data = p._data.detach().to(torch.bfloat16)
        opt = tp.optimizer.SGD(learning_rate=1e-4, parameters=[p],
                               multi_precision=True)
        for _ in range(200):
            p.grad = tp.to_tensor(np.ones((8,), np.float32)).astype("bfloat16")
            opt.step()
            opt.clear_grad()
        mw = opt._accumulators["master_weight"][id(p)]
        np.testing.assert_allclose(mw.numpy(), 1.0 - 200 * 1e-4, rtol=1e-5)
        # model copy tracks the master, cast down
        assert p.numpy()[0] < 1.0

    def test_without_multi_precision_bf16_loses_small_updates(self, on_cpu):
        p = tp.Parameter(np.ones((8,), np.float32))
        p._data = p._data.detach().to(torch.bfloat16)
        opt = tp.optimizer.SGD(learning_rate=1e-4, parameters=[p],
                               multi_precision=False)
        for _ in range(5):
            p.grad = tp.to_tensor(np.ones((8,), np.float32)).astype("bfloat16")
            opt.step()
            opt.clear_grad()
        # documents the bf16 rounding behavior the master path avoids
        assert p.numpy()[0] == 1.0

    def test_master_weight_in_state_dict_roundtrip(self, on_cpu):
        p = tp.Parameter(np.ones((4,), np.float32))
        p._data = p._data.detach().to(torch.bfloat16)
        opt = tp.optimizer.AdamW(learning_rate=1e-3, parameters=[p],
                                 multi_precision=True)
        p.grad = tp.to_tensor(np.full((4,), 0.5, np.float32)).astype("bfloat16")
        opt.step()
        sd = opt.state_dict()
        assert any(k.startswith("master_weight") for k in sd)
        p2 = tp.Parameter(np.ones((4,), np.float32))
        p2._data = p2._data.detach().to(torch.bfloat16)
        opt2 = tp.optimizer.AdamW(learning_rate=1e-3, parameters=[p2],
                                  multi_precision=True)
        opt2.set_state_dict(sd)
        mw2 = opt2._accumulators["master_weight"][id(p2)]
        assert mw2.dtype == torch.float32


def test_set_state_dict_preserves_f32_moments_on_bf16_params(on_cpu):
    """Restoring f32 Adam moments into a fresh optimizer over bf16 params must
    NOT downcast them to bf16."""
    p = tp.Parameter(np.ones((4,), np.float32))
    opt = tp.optimizer.Adam(learning_rate=1e-3, parameters=[p])
    p.grad = tp.to_tensor(np.full((4,), 0.25, np.float32))
    opt.step()
    sd = opt.state_dict()
    assert sd["moment1_0"].dtype == torch.float32
    p2 = tp.Parameter(np.ones((4,), np.float32))
    p2._data = p2._data.detach().to(torch.bfloat16)
    opt2 = tp.optimizer.Adam(learning_rate=1e-3, parameters=[p2])
    opt2.set_state_dict(sd)
    m1 = opt2._accumulators["moment1"][id(p2)]
    assert m1.dtype == torch.float32
    np.testing.assert_allclose(m1.numpy(), sd["moment1_0"].numpy())


class TestNewOptimizersVsTorch:
    """NAdam / RAdam / Rprop update math vs torch.optim on identical streams."""

    def _run_pair(self, make_ours, make_torch, steps=5, rtol=2e-4):
        rng2 = np.random.RandomState(3)
        w0 = rng2.rand(6, 4).astype(np.float32)
        grads = [rng2.randn(6, 4).astype(np.float32) for _ in range(steps)]
        p = tp.to_tensor(w0.copy(), stop_gradient=False)
        opt = make_ours([p])
        tpar = torch.nn.Parameter(torch.from_numpy(w0.copy()))
        topt = make_torch([tpar])
        for g in grads:
            p.grad = tp.to_tensor(g)
            opt.step()
            opt.clear_grad()
            tpar.grad = torch.from_numpy(g)
            topt.step()
            topt.zero_grad()
        np.testing.assert_allclose(p.numpy(), tpar.detach().numpy(),
                                   rtol=rtol, atol=1e-5)

    def test_nadam_matches_torch(self, on_cpu):
        self._run_pair(
            lambda ps: tp.optimizer.NAdam(learning_rate=0.01, parameters=ps),
            lambda ps: torch.optim.NAdam(ps, lr=0.01))

    def test_radam_matches_torch(self, on_cpu):
        self._run_pair(
            lambda ps: tp.optimizer.RAdam(learning_rate=0.01, parameters=ps),
            lambda ps: torch.optim.RAdam(ps, lr=0.01), steps=8)

    def test_rprop_matches_torch(self, on_cpu):
        self._run_pair(
            lambda ps: tp.optimizer.Rprop(learning_rate=0.01, parameters=ps),
            lambda ps: torch.optim.Rprop(ps, lr=0.01), steps=6)

    def test_asgd_sag_semantics(self, on_cpu):
        # constant grads: d/min(m+1,n) == 1 every step -> x -= lr each step
        p = tp.to_tensor(np.ones((4,), np.float32), stop_gradient=False)
        opt = tp.optimizer.ASGD(learning_rate=0.1, batch_num=2, parameters=[p])
        for _ in range(5):
            p.grad = tp.to_tensor(np.ones(4, np.float32))
            opt.step()
            opt.clear_grad()
        np.testing.assert_allclose(p.numpy(), 0.5, rtol=1e-5)
        # alternating batch grads: d averages the two slots
        q = tp.to_tensor(np.zeros((2,), np.float32), stop_gradient=False)
        opt2 = tp.optimizer.ASGD(learning_rate=1.0, batch_num=2, parameters=[q])
        for g in (2.0, 4.0):
            q.grad = tp.to_tensor(np.full(2, g, np.float32))
            opt2.step()
            opt2.clear_grad()
        # step1: -1*2/1 = -2 ; step2: -(2+4)/2 = -3 -> total -5
        np.testing.assert_allclose(q.numpy(), -5.0, rtol=1e-5)
