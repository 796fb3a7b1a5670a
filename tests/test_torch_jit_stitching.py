"""Stitched graph breaks in ``paddle_tpu_torch.jit.to_static`` against the
JAX package's, on the CPU: a twin of each of ``tests/test_jit_stitching.py``'s
10 tests.  float()/.numpy() inside a captured step do NOT de-compile the
signature — the step stays one program, and the python around the break
observes true per-call values.

Each twin runs the step on both packages from the same numpy weights and
batches and holds the port's losses to the JAX package's captured step and
to the port's eager step at the reference's tolerances.  On the CPU the
captured body runs every call and its breaks see the true values (the card
echoes the python after each replay instead, ``jit/to_static.py``), so a
metric hook runs once a call on both; the echo pass itself is driven on
the CPU directly (``StaticFunction._echo``) where a twin needs it.
"""
import logging

import numpy as np
import pytest
import torch
from torch.utils._pytree import tree_flatten

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
import paddle_tpu_torch as tp
import paddle_tpu_torch.nn as tnn
from paddle_tpu_torch.core import device as tdevice


@pytest.fixture(autouse=True, scope="module")
def on_cpu():
    prev = tdevice._current_device
    tp.set_device("cpu")
    yield
    tdevice._current_device = prev


def _model_and_opt(pkg, seed=0, lr=0.05):
    """The JAX Linear from the seed; the port's holds its weights."""
    paddle.seed(seed)
    jm = jnn.Linear(8, 4)
    if pkg is paddle:
        m = jm
    else:
        m = tnn.Linear(8, 4)
        m.set_state_dict({k: np.asarray(v.numpy())
                          for k, v in jm.state_dict().items()})
    opt = pkg.optimizer.AdamW(learning_rate=lr, parameters=m.parameters())
    return m, opt


def _data(pkg, seed=0, n=6):
    rng = np.random.RandomState(seed)
    return [(pkg.to_tensor(rng.rand(16, 8).astype(np.float32)),
             pkg.to_tensor(rng.rand(16, 4).astype(np.float32)))
            for _ in range(n)]


def _np(t):
    return np.asarray(t.numpy(), np.float32)


def _eager_losses(pkg=tp, n=6):
    m, opt = _model_and_opt(pkg)
    out = []
    for x, y in _data(pkg, n=n):
        loss = ((m(x) - y) ** 2).mean()
        loss.backward()
        opt.step()
        opt.clear_grad()
        out.append(float(loss))
    return out


def _metric_step(pkg, metrics):
    m, opt = _model_and_opt(pkg)

    def train_step(x, y):
        loss = ((m(x) - y) ** 2).mean()
        loss.backward()
        opt.step()
        opt.clear_grad()
        metrics.append(float(loss))      # the break
        return loss

    return pkg.jit.to_static(train_step)


class TestFloatBreakStitching:
    def test_float_loss_metric_hook_stays_compiled(self):
        """float(loss) in a metric callback: losses match eager and the JAX
        package's capture, the metric list holds TRUE per-call values, and
        the captured program runs every call."""
        metrics, jmetrics = [], []
        step = _metric_step(tp, metrics)
        jstep = _metric_step(paddle, jmetrics)
        losses = [float(_np(step(x, y))) for x, y in _data(tp)]
        jlosses = [float(np.asarray(jstep(x, y)._data))
                   for x, y in _data(paddle)]
        ref = _eager_losses()
        np.testing.assert_allclose(losses, ref, rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(losses, jlosses, rtol=2e-5, atol=2e-5)
        # steady state: the metric hook observed the true value of every call
        np.testing.assert_allclose(metrics[-4:], ref[-4:],
                                   rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(metrics[-4:], jmetrics[-4:],
                                   rtol=2e-5, atol=2e-5)
        assert len(set(np.round(metrics, 6))) > 1   # values actually change

        group = next(iter(step._cache.values()))
        assert not group.eager_only
        entry = group.variants[0]
        assert entry.compiled is not None
        assert entry.break_kinds == ("float",)
        assert len(entry.op_tape) > 0
        # steady state: exactly one append per call
        n = len(metrics)
        step(*_data(tp)[0])
        assert len(metrics) == n + 1

    def test_compiled_program_runs_every_call(self):
        seen = []
        step = _metric_step(tp, seen)
        data = _data(tp)
        step(*data[0])                       # spy
        step(*data[1])                       # capture (or re-spy: lazy state)
        step(*data[2])
        group = next(iter(step._cache.values()))
        entry = group.variants[0]
        calls = []
        orig = entry.compiled.launch
        entry.compiled.launch = lambda: (calls.append(1), orig())[1]
        step(*data[3])
        step(*data[4])
        assert len(calls) == 2               # launch-count hook: both calls
        assert not group.eager_only          # ...ran the captured program

    def test_numpy_break(self):
        grabbed = []
        m, opt = _model_and_opt(tp)

        def train_step(x, y):
            pred = m(x)
            loss = ((pred - y) ** 2).mean()
            loss.backward()
            opt.step()
            opt.clear_grad()
            grabbed.append(pred.numpy().copy())   # full-array break
            return loss

        step = tp.jit.to_static(train_step)
        data = _data(tp)
        for x, y in data[:2]:                 # capture warmup
            step(x, y)
        grabbed.clear()
        for x, y in data[2:5]:                # steady state
            step(x, y)
        group = next(iter(step._cache.values()))
        assert not group.eager_only
        assert group.variants[0].break_kinds == ("numpy",)
        assert len(grabbed) == 3 and grabbed[0].shape == (16, 4)
        # weights move every step, so consecutive grabbed preds must differ
        assert not np.allclose(grabbed[1], grabbed[2])
        # ...and are the JAX package's predictions on the same trajectory
        jm, jopt = _model_and_opt(paddle)
        jpred = []
        for x, y in _data(paddle)[:5]:
            pred = jm(x)
            loss = ((pred - y) ** 2).mean()
            loss.backward()
            jopt.step()
            jopt.clear_grad()
            jpred.append(np.asarray(pred.numpy()))
        np.testing.assert_allclose(grabbed, jpred[2:5], rtol=2e-5, atol=2e-5)

    def test_fstring_logging_break(self):
        lines = []
        m, opt = _model_and_opt(tp)

        def train_step(x, y):
            loss = ((m(x) - y) ** 2).mean()
            loss.backward()
            opt.step()
            opt.clear_grad()
            lines.append(f"loss={loss:.6f}")     # __format__ break
            return loss

        step = tp.jit.to_static(train_step)
        data = _data(tp)
        step(*data[0])                        # capture warmup
        step(*data[1])
        lines.clear()
        losses = [float(_np(step(x, y))) for x, y in data[2:5]]
        group = next(iter(step._cache.values()))
        assert not group.eager_only
        assert lines == [f"loss={v:.6f}" for v in np.float32(losses)]
        np.testing.assert_allclose(losses, _eager_losses()[2:5], rtol=2e-5,
                                   atol=2e-5)

    def test_break_plus_guard_coexist(self):
        metrics = []
        m, opt = _model_and_opt(tp)

        def train_step(x, y, flag):
            loss = ((m(x) - y) ** 2).mean()
            if bool(flag):                        # int/bool value guard
                loss = loss * 2.0
            loss.backward()
            opt.step()
            opt.clear_grad()
            metrics.append(float(loss))          # stitched break
            return loss

        step = tp.jit.to_static(train_step)
        data = _data(tp)
        t = tp.to_tensor(np.array(1, np.int32))
        f = tp.to_tensor(np.array(0, np.int32))
        step(data[0][0], data[0][1], t)          # capture warmup
        step(data[1][0], data[1][1], t)
        metrics.clear()
        l2 = float(_np(step(data[2][0], data[2][1], t)))
        assert metrics[-1] == pytest.approx(l2, rel=1e-6)
        l3 = float(_np(step(data[3][0], data[3][1], f)))  # guard
        group = next(iter(step._cache.values()))
        assert not group.eager_only
        assert len(group.variants) == 2          # one per guard branch
        assert metrics[-1] == pytest.approx(l3, rel=1e-6)
        # the JAX package's step over the same flags
        jm, jopt = _model_and_opt(paddle)
        jl = []
        for (x, y), flag in zip(_data(paddle)[:4], (1, 1, 1, 0)):
            loss = ((jm(x) - y) ** 2).mean()
            if flag:
                loss = loss * 2.0
            loss.backward()
            jopt.step()
            jopt.clear_grad()
            jl.append(float(loss))
        np.testing.assert_allclose([l2, l3], jl[2:4], rtol=2e-5, atol=2e-5)

    def test_op_divergence_on_break_value_falls_back_loudly(self, caplog):
        """Tensor ops conditioned on a float() break value cannot be stitched:
        the op-sequence check catches the flip, the state writes are rolled
        back, the call runs eagerly (correct numbers), and the signature
        pins eager-only with a warning — never silently wrong."""
        m, opt = _model_and_opt(tp)
        losses = []

        def train_step(x, y, thresh):
            loss = ((m(x) - y) ** 2).mean()
            if float(loss) > thresh:             # break value drives op flow
                loss = loss * 2.0                # extra op on one path only
            loss.backward()
            opt.step()
            opt.clear_grad()
            losses.append(float(loss))
            return loss

        step = tp.jit.to_static(train_step)
        data = _data(tp)
        with caplog.at_level(logging.WARNING, logger="paddle_tpu_torch.jit"):
            vals = []
            for i in range(30):
                x, y = data[i % len(data)]
                vals.append(float(_np(step(x, y, 0.5))))
        group = next(iter(step._cache.values()))
        assert group.eager_only          # pinned, not silently wrong
        assert any("eager" in r.message for r in caplog.records)
        # eager twins (the port's and the JAX package's) across the WHOLE
        # trajectory, incl. the fallback call: state was never corrupted
        refs = {}
        for pkg in (tp, paddle):
            m2, opt2 = _model_and_opt(pkg)
            ref, pdata = [], _data(pkg)
            for i in range(30):
                x, y = pdata[i % len(pdata)]
                loss = ((m2(x) - y) ** 2).mean()
                if float(loss) > 0.5:
                    loss = loss * 2.0
                loss.backward()
                opt2.step()
                opt2.clear_grad()
                ref.append(float(loss))
            refs[pkg.__name__] = ref
        np.testing.assert_allclose(vals, refs["paddle_tpu_torch"], rtol=2e-4,
                                   atol=2e-5)
        np.testing.assert_allclose(vals, refs["paddle_tpu"], rtol=2e-4,
                                   atol=2e-5)

    def test_scan_steps_rejects_breaks_eagerly(self):
        m, opt = _model_and_opt(tp)
        metrics = []

        def train_step(x, y):
            loss = ((m(x) - y) ** 2).mean()
            loss.backward()
            opt.step()
            opt.clear_grad()
            metrics.append(float(loss))
            return loss

        step = tp.jit.scan_steps(train_step)
        rng = np.random.RandomState(0)
        xs = tp.to_tensor(rng.rand(3, 16, 8).astype(np.float32))
        ys = tp.to_tensor(rng.rand(3, 16, 4).astype(np.float32))
        step(xs, ys)                            # falls back to eager loop
        step(xs, ys)
        group = next(iter(step._cache.values()))
        assert group.eager_only                  # documented restriction
        assert len(metrics) == 6                 # but all steps really ran


class TestMultipleBreaks:
    def test_two_floats_and_numpy_in_order(self):
        """Several breaks per step: values arrive in program order, every
        call, with the step still captured."""
        m, opt = _model_and_opt(tp)
        seen = []

        def train_step(x, y):
            pred = m(x)
            loss = ((pred - y) ** 2).mean()
            pre = float(loss)                  # break 1 (pre-update loss)
            loss.backward()
            opt.step()
            opt.clear_grad()
            seen.append((pre, pred.numpy().mean(), float(loss)))  # 2, 3
            return loss

        step = tp.jit.to_static(train_step)
        data = _data(tp)
        step(*data[0])                         # capture warmup
        step(*data[1])
        seen.clear()
        vals = [float(_np(step(x, y))) for x, y in data[2:5]]
        group = next(iter(step._cache.values()))
        assert not group.eager_only
        assert group.variants[0].break_kinds == ("float", "numpy", "float")
        assert len(seen) == 3
        for (pre, pmean, post), v in zip(seen, vals):
            assert pre == pytest.approx(v, rel=1e-5)   # same tensor read 2x
            assert post == pytest.approx(v, rel=1e-5)
            assert np.isfinite(pmean)
        # distinct calls observed distinct values
        assert seen[0][0] != seen[1][0]
        np.testing.assert_allclose(vals, _eager_losses()[2:5], rtol=2e-5,
                                   atol=2e-5)


class TestEchoPlaceholders:
    def test_smuggled_tensor_raises_clearly_post_echo(self):
        """A Tensor appended to a list inside the step and read AFTER the
        call is an echo-pass placeholder on the card's steady-state calls
        (its buffer is a meta tensor, not data). The host read raises a
        pointed error.  The echo pass runs here on the CPU directly, with
        the true break value, and changes no state."""
        m, opt = _model_and_opt(tp)
        kept, metrics = [], []

        def train_step(x, y):
            loss = ((m(x) - y) ** 2).mean()
            loss.backward()
            opt.step()
            opt.clear_grad()
            metrics.append(float(loss))       # stitched break: fine
            kept.append(loss)                 # placeholder smuggled out
            return loss

        step = tp.jit.to_static(train_step)
        data = _data(tp)
        for x, y in data[:3]:
            step(x, y)
        group = next(iter(step._cache.values()))
        assert not group.eager_only           # the smuggle alone can't pin
        entry = group.variants[0]
        w = _np(m.weight)
        leaves = tree_flatten((data[3], {}))[0]
        step._echo(entry, leaves, (), [np.float32(1.25)])
        assert metrics[-1] == 1.25            # the python saw the true value
        np.testing.assert_array_equal(_np(m.weight), w)   # no compute
        assert m.weight.grad is None
        for fn in (lambda t: float(t), lambda t: t.numpy(),
                   lambda t: t.item(), lambda t: int(t)):
            with pytest.raises(RuntimeError, match="placeholder"):
                fn(kept[-1])
        # the error points the user at the stitching scheme docs
        with pytest.raises(RuntimeError, match="to_static"):
            kept[-1].numpy()

    def test_float_break_keeps_traced_dtype(self):
        """Break values ride out of the captured program in their traced
        dtype — an f32 round trip would be observable for large int64
        counters — and come back exact through the one packed host read."""
        from paddle_tpu_torch.jit.to_static import (
            _CacheEntry, _CaptureContext, _pack, _unpack)
        entry = _CacheEntry()
        entry.events = (("float", 2.0),)
        entry.known_ids, entry.write_ids = set(), set()
        from paddle_tpu_torch.core.tensor import _wrap
        for v, dt in ((2, torch.int32), (2 ** 40 + 1, torch.int64),
                      (2.0, torch.float32)):
            ctx = _CaptureContext(entry, {})
            t = _wrap(torch.tensor(v, dtype=dt))
            ctx.on_scalar(t, "float", float)
            assert ctx.break_outs[0].dtype == t.dtype    # not cast to f32
            packed = _pack(entry, ctx.guard_outs, ctx.break_outs)
            _, (v,) = _unpack(entry, packed)
            assert v.item() == t.numpy().item() == v
