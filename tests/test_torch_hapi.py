"""The port's high-level API and metrics (``paddle_tpu_torch/hapi/``,
``metric/``) against the JAX package's on the CPU.

- ``Model.fit`` / ``evaluate`` / ``predict`` on both packages from the same
  numpy weights and data with SGD: per-batch and per-epoch losses within
  1e-5 (relative), metrics equal, predictions at rtol 1e-5 / atol 1e-6;
  with no shuffle and with ``fit``'s own shuffle under one
  ``np.random.seed``.
- ``tests/test_partial_fills.py``'s callback and export cases; every
  callback; ``save`` / ``load`` restoring the model and its optimizer; the
  ``training=False`` refusal, which names ``jit.save``.
- ``summary`` and ``flops`` equal; ``Accuracy`` / ``Precision`` /
  ``Recall`` / ``Auc`` / ``accuracy`` equal on the same arrays (ties
  included, and bf16 predictions read as float32).
- The copies ``hapi/{__init__,callbacks,model}.py`` and
  ``metric/__init__.py``: ASTs held to the reference's but the units
  ``DIVERGENT`` lists.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu.nn as jnn
import paddle_tpu_torch as tp
import paddle_tpu_torch.nn as nn
from paddle_tpu import io as jio
from paddle_tpu import metric as jmetric
from paddle_tpu.hapi import callbacks as jcb
from paddle_tpu_torch import io as tio
from paddle_tpu_torch import metric as tmetric
from paddle_tpu_torch.hapi import callbacks as tcb
from _torch_copies import differing_units, statement
from paddle_tpu_torch.core import device as tdevice

rng = np.random.RandomState(0)
LOSS = dict(rtol=1e-5)
OUT = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(autouse=True, scope="module")
def on_cpu():
    prev = tdevice._current_device
    tp.set_device("cpu")
    yield
    tdevice._current_device = prev


PKGS = {"port": (tp, nn, tio, tmetric, tcb), "ref": (pt, jnn, jio, jmetric,
                                                      jcb)}


def _data(n=32, seed=1):
    r = np.random.RandomState(seed)
    x = r.randn(n, 8).astype(np.float32)
    y = (x[:, :3].argmax(1)).astype(np.int64).reshape(n, 1)
    return x, y


def _net(which, seed=3):
    """The same classifier on both packages: the port's takes the JAX
    one's weights."""
    pt.seed(seed)
    jm = jnn.Sequential(jnn.Linear(8, 16), jnn.ReLU(), jnn.Linear(16, 3))
    if which == "ref":
        return jm
    tm = nn.Sequential(nn.Linear(8, 16), nn.ReLU(), nn.Linear(16, 3))
    assert tm.set_state_dict({k: np.asarray(v.numpy()) for k, v in
                              jm.state_dict().items()}) == ([], [])
    return tm


class _Spy:
    def __init__(self, cb):
        class Spy(cb.Callback):
            def __init__(self):
                self.events = []

            def on_train_begin(self, logs=None):
                self.events.append(("train_begin",))

            def on_epoch_begin(self, epoch, logs=None):
                self.events.append(("begin", epoch))

            def on_train_batch_begin(self, step, logs=None):
                self.events.append(("batch_begin", step))

            def on_train_batch_end(self, step, logs=None):
                self.events.append(("batch", step, logs["loss"]))

            def on_epoch_end(self, epoch, logs=None):
                self.events.append(("end", epoch, logs["loss"]))

            def on_train_end(self, logs=None):
                self.events.append(("train_end",))
        self.cb = Spy()


def _workflow(which, shuffle, metrics=("acc",)):
    pkg, mod, io, metric, cb = PKGS[which]
    x, y = _data()
    ex, ey = _data(12, seed=2)
    net = _net(which)
    model = pkg.Model(net)
    mets = [metric.Accuracy(topk=(1, 2)) if m == "acc2" else
            metric.Accuracy() for m in metrics]
    model.prepare(pkg.optimizer.SGD(learning_rate=0.2,
                                    parameters=net.parameters()),
                  mod.CrossEntropyLoss(), mets)
    spy = _Spy(cb).cb
    if shuffle:
        np.random.seed(21)
        train = io.TensorDataset([x, y])
        hist = model.fit(train, batch_size=8, epochs=3, verbose=0,
                         callbacks=[spy])
    else:
        train = io.DataLoader(io.TensorDataset([x, y]), batch_size=8)
        hist = model.fit(train, epochs=3, verbose=0, callbacks=[spy],
                         num_iters=10)
    ev = model.evaluate(io.TensorDataset([ex, ey]), batch_size=5, verbose=0)
    pred = model.predict(io.TensorDataset([ex, ey]), batch_size=5,
                         stack_outputs=True)[0]
    batches = model.predict(io.TensorDataset([ex]), batch_size=5)[0]
    return hist, spy.events, ev, pred, batches


@pytest.mark.parametrize("shuffle", [False, True], ids=["loader", "shuffle"])
@pytest.mark.parametrize("metrics", [("acc",), ("acc2",)])
def test_fit_evaluate_predict_match_the_reference(shuffle, metrics):
    th, te, tev, tpred, tb = _workflow("port", shuffle, metrics)
    jh, je, jev, jpred, jb = _workflow("ref", shuffle, metrics)
    np.testing.assert_allclose(th, jh, **LOSS)
    assert [e[:2] for e in te] == [e[:2] for e in je]
    np.testing.assert_allclose([e[2] for e in te if len(e) == 3],
                               [e[2] for e in je if len(e) == 3], **LOSS)
    assert tev.keys() == jev.keys()
    np.testing.assert_allclose(tev["loss"], jev["loss"], **LOSS)
    for k in tev:
        if k != "loss":
            assert tev[k] == jev[k], k
    assert type(tpred) is np.ndarray and tpred.shape == (12, 3)
    np.testing.assert_allclose(tpred, np.asarray(jpred), **OUT)
    assert [b.shape for b in tb] == [np.asarray(b).shape for b in jb]
    assert sum(e[0] == "batch" for e in te) == (10 if not shuffle else 12)


def test_train_and_eval_batch_return_the_references():
    x, y = _data(8)
    res = []
    for which in ("port", "ref"):
        pkg, mod, _, metric, _ = PKGS[which]
        net = _net(which, seed=5)
        m = pkg.Model(net)
        m.prepare(pkg.optimizer.SGD(learning_rate=0.1,
                                    parameters=net.parameters()),
                  mod.CrossEntropyLoss(), metric.Accuracy())
        a = m.train_batch(pkg.to_tensor(x), pkg.to_tensor(y))
        b = m.train_batch([pkg.to_tensor(x)], pkg.to_tensor(y), update=False)
        c = m.eval_batch(pkg.to_tensor(x), pkg.to_tensor(y))
        m2 = pkg.Model(net)
        m2.prepare(pkg.optimizer.SGD(learning_rate=0.1,
                                     parameters=net.parameters()),
                   mod.CrossEntropyLoss())
        d = m2.eval_batch(pkg.to_tensor(x), pkg.to_tensor(y))
        res.append((a, b, c, d))
    for got, want in zip(*res):
        assert type(got) is type(want)
        if isinstance(got, tuple):
            np.testing.assert_allclose(got[0], want[0], **LOSS)
            assert got[1] == want[1]
        else:
            np.testing.assert_allclose(got, want, **LOSS)


def test_callbacks_fire_and_early_stop(tmp_path):
    """``tests/test_partial_fills.py``'s case on the port."""
    seen = []

    class Spy(tcb.Callback):
        def on_epoch_begin(self, epoch, logs=None):
            seen.append(("begin", epoch))

        def on_train_batch_end(self, step, logs=None):
            seen.append(("batch", step, logs["loss"]))

        def on_epoch_end(self, epoch, logs=None):
            seen.append(("end", epoch, logs["loss"]))

    tp.seed(0)
    x = rng.rand(8, 4).astype(np.float32)
    yv = rng.rand(8, 1).astype(np.float32)
    ds = tio.TensorDataset([tp.to_tensor(x), tp.to_tensor(yv)])
    m = tp.Model(nn.Linear(4, 1))
    m.prepare(optimizer=tp.optimizer.SGD(
        learning_rate=1e9, parameters=m.parameters()),   # diverges
        loss=nn.MSELoss())
    stopper = tcb.EarlyStopping(monitor="loss", mode="min", patience=0,
                                verbose=0)
    m.fit(ds, batch_size=4, epochs=10, verbose=0,
          callbacks=[Spy(), stopper,
                     tcb.ModelCheckpoint(save_dir=str(tmp_path))])
    assert any(e[0] == "begin" for e in seen)
    assert any(e[0] == "batch" for e in seen)
    epochs_run = max(e[1] for e in seen if e[0] == "end") + 1
    assert epochs_run < 10
    assert (tmp_path / "0.pdparams").exists()
    assert (tmp_path / "0.pdopt").exists()


def test_lr_scheduler_and_progbar_callbacks(capsys):
    """``LRScheduler`` as the reference's: it looks for the scheduler under
    the optimizer's ``_learning_rate``, which neither package's optimizer
    has (it keeps ``_lr_scheduler``), so the rate stays where it was on
    both (a reference fault, copied as it is); ``ProgBarLogger`` prints
    its lines."""
    x, y = _data(16)
    rates = []
    for which in ("port", "ref"):
        pkg, mod, io, _, cb = PKGS[which]
        net = _net(which)
        sched = pkg.optimizer.lr.StepDecay(0.5, step_size=1, gamma=0.5)
        m = pkg.Model(net)
        m.prepare(pkg.optimizer.SGD(learning_rate=sched,
                                    parameters=net.parameters()),
                  mod.CrossEntropyLoss())
        m.fit(io.DataLoader(io.TensorDataset([x, y]), batch_size=8),
              epochs=2, verbose=0,
              callbacks=[cb.LRScheduler(by_step=True, by_epoch=True),
                         cb.ProgBarLogger(log_freq=1, verbose=1)])
        rates.append(sched.last_lr)
    assert rates[0] == rates[1] == 0.5
    out = capsys.readouterr().out
    assert out.count("Epoch 1 step 0 loss") == 2
    assert out.count("Epoch 2 done") == 2


def test_early_stopping_by_accuracy_saves_the_best(tmp_path):
    res = []
    for which in ("port", "ref"):
        _, _, _, _, cb = PKGS[which]
        (tmp_path / which).mkdir()
        es = cb.EarlyStopping(monitor="acc", patience=1, verbose=0,
                              save_dir=str(tmp_path / which))

        class M:
            def save(self, path):
                open(path + ".saved", "w").close()
        es.set_model(M())
        es.on_train_begin()
        stops = []
        for epoch, acc in enumerate([0.5, 0.7, 0.6, 0.65, 0.9]):
            es.on_epoch_end(epoch, {"acc": [acc]})
            stops.append(es.stop_training)
        res.append((stops, es.best, es.wait))
        assert (tmp_path / which / "best_model.saved").exists()
    assert res[0] == res[1] == ([False, False, False, True, True], 0.9, 0)


def test_save_load_restores_model_and_optimizer(tmp_path):
    """A fresh Model loaded from ``save`` evaluates bitwise the saved one
    and takes the next step bitwise the saving Model's (the Adam state
    came back); ``reset_optimizer`` skips it."""
    x, y = _data(16)
    xt, yt = tp.to_tensor(x), tp.to_tensor(y)

    def model(seed):
        net = _net("port", seed)
        m = tp.Model(net)
        m.prepare(tp.optimizer.Adam(learning_rate=0.05,
                                    parameters=net.parameters()),
                  nn.CrossEntropyLoss(), tmetric.Accuracy())
        return m

    a = model(3)
    for _ in range(3):
        a.train_batch(xt, yt)
    path = str(tmp_path / "ck" / "final")
    a.save(path)
    b, c = model(4), model(5)
    b.load(path)
    c.load(path, reset_optimizer=True)
    ds = tio.TensorDataset([x, y])
    assert a.evaluate(ds, batch_size=4, verbose=0) == \
        b.evaluate(ds, batch_size=4, verbose=0)
    la, lb, lc = (m.train_batch(xt, yt) for m in (a, b, c))
    assert la == lb and la == lc          # the loss before the step
    la, lb, lc = (m.train_batch(xt, yt)[0] for m in (a, b, c))
    assert la == lb and la != lc
    for p, q in zip(a.parameters(), b.parameters()):
        assert torch.equal(p._data, q._data)


def test_inference_save_is_refused_naming_jit_save(tmp_path):
    from paddle_tpu_torch.jit import InputSpec
    m = tp.Model(nn.Linear(2, 2))
    with pytest.raises(ValueError, match="input specs"):
        m.save(str(tmp_path / "x"), training=False)
    m = tp.Model(nn.Linear(4, 2),
                 inputs=[InputSpec([None, 4], "float32", "x")])
    with pytest.raises(NotImplementedError, match="jit.save"):
        m.save(str(tmp_path / "infer"), training=False)
    assert not list(tmp_path.iterdir())


def test_summary_and_flops_equal_the_references(capsys):
    nets = []
    for which in ("port", "ref"):
        pkg, mod, *_ = PKGS[which]
        pkg.seed(0)
        net = mod.Sequential(mod.Conv2D(3, 4, 3), mod.ReLU(),
                             mod.Flatten(), mod.Linear(4 * 6 * 6, 5))
        net[3].bias.stop_gradient = True
        nets.append((pkg, net))
    res = []
    for pkg, net in nets:
        s = pkg.summary(net, (1, 3, 8, 8))
        text = capsys.readouterr().out
        res.append((s, text, pkg.flops(net, [1, 3, 8, 8]),
                    pkg.Model(net).summary()))
        capsys.readouterr()
    assert res[0] == res[1]
    assert res[0][0] == {"total_params": 4 * 3 * 9 + 4 + 144 * 5 + 5,
                         "trainable_params": 4 * 3 * 9 + 4 + 144 * 5}


# ---- metrics ----------------------------------------------------------------
def _metric_arrays():
    r = np.random.RandomState(7)
    pred = r.rand(40, 5).astype(np.float32)
    pred[3] = 0.5                                  # an all-tie row
    pred[4, [1, 3]] = pred[4].max() + 0.1          # a tie at the top
    label = r.randint(0, 5, (40, 1))
    prob = r.rand(40, 1).astype(np.float32)
    prob2 = r.rand(40, 2).astype(np.float32)
    binary = r.randint(0, 2, (40, 1))
    return pred, label, prob, prob2, binary


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_metrics_equal_the_references(dtype):
    pred, label, prob, prob2, binary = _metric_arrays()
    res = []
    for which in ("port", "ref"):
        pkg, _, _, metric, _ = PKGS[which]

        def t(a):
            v = pkg.to_tensor(a)
            return v.astype(dtype) if a.dtype == np.float32 else v
        out = {}
        for topk in ((1,), (1, 3)):
            acc = metric.Accuracy(topk=topk)
            for lo in (0, 20):
                c = acc.compute(t(pred[lo:lo + 20]), t(label[lo:lo + 20]))
                out[f"acc{topk}_update{lo}"] = acc.update(c)
            out[f"acc{topk}"] = acc.accumulate()
            out[f"acc{topk}_name"] = acc.name()
        for cls in (metric.Precision, metric.Recall):
            m = cls()
            m.update(t(prob), t(binary))
            m.update(t(prob[:7]), t(binary[:7]))
            out[m.name()] = m.accumulate()
        for name, p in (("auc", prob), ("auc2", prob2)):
            m = metric.Auc(num_thresholds=255)
            m.update(t(p), t(binary))
            out[name] = m.accumulate()
            m.reset()
            out[name + "_empty"] = m.accumulate()
        for k in (1, 2, 5):
            out[f"accuracy{k}"] = float(metric.accuracy(t(pred), t(label),
                                                        k=k))
        res.append(out)
    assert res[0] == res[1]


def test_accuracy_ties_take_the_lower_index():
    """``accuracy``'s top-k breaks a tie toward the lower index, as the
    reference's ``top_k`` does."""
    p = np.asarray([[1.0, 2.0, 2.0, 0.0]], np.float32)
    for which in ("port", "ref"):
        pkg, _, _, metric, _ = PKGS[which]
        assert float(metric.accuracy(pkg.to_tensor(p),
                                     pkg.to_tensor(np.asarray([[1]])))) == 1
        assert float(metric.accuracy(pkg.to_tensor(p),
                                     pkg.to_tensor(np.asarray([[2]])))) == 0


# ---- copies -----------------------------------------------------------------
DIVERGENT = {
    "hapi/__init__.py": set(),
    "hapi/callbacks.py": set(),
    # a host copy of the prediction, from the card too
    "hapi/model.py": {statement("from ..metric import _host"),
                      "Model.predict_batch"},
    "metric/__init__.py": {
        "__doc__", statement("import torch"), "_host",
        "Accuracy.compute", "Accuracy.update", "Precision.update",
        "Recall.update", "Auc.update",
        # the port's stable topk in place of jax.lax.top_k
        "accuracy"},
}


@pytest.mark.parametrize("path", sorted(DIVERGENT))
def test_copy_matches_the_reference(path):
    assert differing_units(path) == DIVERGENT[path]


def test_top_level_names_are_the_references():
    for name in ("Model", "summary", "flops", "save", "load"):
        assert getattr(tp, name).__name__ == getattr(pt, name).__name__
    assert tp.Model is tp.hapi.Model and tp.summary is tp.hapi.summary
    assert tp.save is tp.framework.save and tp.load is tp.framework.load
    assert tp.io.DataLoader is tio.DataLoader
    assert tp.metric.Accuracy is tmetric.Accuracy
