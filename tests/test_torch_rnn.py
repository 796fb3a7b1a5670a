"""The port's recurrent layers (``paddle_tpu_torch/nn/layer/rnn.py``)
against the JAX package's, on the CPU.

Each layer is built by the JAX package from a seed; its ``state_dict`` as
numpy arrays loads into the port's through ``set_state_dict`` (the same
names and layouts: ``weight_ih_l{k}[_reverse]`` [gates * H, in], gates in
the reference's order).  The port's multi-layer nets run each layer and
direction through torch's fused recurrence (``torch._VF``); the reference
scans its cell math.  Tolerances: float32 outputs and states at 1e-5,
gradients (of a weighted sum of the outputs, inputs and every parameter)
at 1e-4, as ``tests/test_torch_conv_pool.py`` holds layers.  A
``cuda``-marked case holds the card against the CPU.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu.nn as jnn
import paddle_tpu_torch as tp
import paddle_tpu_torch.nn as tnn
from _torch_copies import differing_units, statement
from paddle_tpu_torch.core import device as tdevice

VAL = dict(rtol=1e-5, atol=1e-5)
GRAD = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(autouse=True, scope="module")
def on_cpu():
    prev = tdevice._current_device
    tp.set_device("cpu")
    yield
    tdevice._current_device = prev


def _pair(cls, *args, **kw):
    pt.seed(0)
    jm = getattr(jnn, cls)(*args, **kw)
    state = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    tp.seed(1)
    tm = getattr(tnn, cls)(*args, **kw)
    missing, unexpected = tm.set_state_dict(state)
    assert not missing and not unexpected
    assert list(tm.state_dict()) == list(state)
    return jm, tm


def _flat(out):
    if isinstance(out, (list, tuple)):
        return [o for v in out for o in _flat(v)]
    return [out]


def _run(m, pkg, arrays, grad=True):
    ins = []
    for a in arrays:
        t = pkg.to_tensor(a)
        if grad:
            t.stop_gradient = False
        ins.append(t)
    return ins, m(*ins)


def _hold(jm, tm, arrays, state_arrays=()):
    """Outputs (every leaf) and the gradients of a weighted sum of them,
    of the inputs and every parameter, on both packages."""
    res = {}
    for pkg, m in ((pt, jm), (tp, tm)):
        ins, out = _run(m, pkg, list(arrays) + list(state_arrays))
        leaves = _flat(out)
        loss = None
        for k, o in enumerate(leaves):
            w = np.random.RandomState(5 + k).uniform(
                0.5, 1.5, o.shape).astype(np.float32)
            term = (o * pkg.to_tensor(w)).sum()
            loss = term if loss is None else loss + term
        loss.backward()
        res[pkg] = ([np.asarray(o.numpy()) for o in leaves],
                    [np.asarray(t.grad.numpy()) for t in ins],
                    {n: np.asarray(p.grad.numpy())
                     for n, p in m.named_parameters()})
    (jo, jg, jp), (to, tg, tpg) = res[pt], res[tp]
    assert len(to) == len(jo)
    for i, (a, b) in enumerate(zip(to, jo)):
        assert a.shape == b.shape, i
        np.testing.assert_allclose(a, b, err_msg=f"output {i}", **VAL)
    for i, (a, b) in enumerate(zip(tg, jg)):
        np.testing.assert_allclose(a, b, err_msg=f"input grad {i}", **GRAD)
    assert set(tpg) == set(jp)
    for n in jp:
        np.testing.assert_allclose(tpg[n], jp[n], err_msg=n, **GRAD)


def _x(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


# the units of the port's rnn.py that differ from the reference's: the
# docstring, the imports, the cells' torch math, and the fused recurrence
# in place of the scan
DIVERGENT = {
    "__doc__",
    statement("import jax"), statement("import jax.numpy as jnp"),
    statement("import torch"),
    statement("from ...ops import creation as _creation"),
    statement('_FUSED = {"LSTM": "lstm", "GRU": "gru", "RNN_TANH": '
              '"rnn_tanh", "RNN_RELU": "rnn_relu"}'),
    "RNNCellBase.get_initial_states", "SimpleRNNCell._step",
    "LSTMCell._step", "GRUCell._step", "_scan_layer",
    "_MultiLayerRNN.forward",
}


def test_copy_matches_the_reference():
    assert differing_units("nn/layer/rnn.py") == DIVERGENT


# ---- cells -------------------------------------------------------------------
@pytest.mark.parametrize("cls,kw", [
    ("SimpleRNNCell", {}), ("SimpleRNNCell", {"activation": "relu"}),
    ("LSTMCell", {}), ("GRUCell", {})],
    ids=["simple_tanh", "simple_relu", "lstm", "gru"])
@pytest.mark.parametrize("with_state", [False, True])
def test_cells(cls, kw, with_state):
    jm, tm = _pair(cls, 6, 8, **kw)
    x = _x(3, 6)
    states = ()
    if with_state:
        states = ((_x(3, 8, seed=1), _x(3, 8, seed=2)),) if cls == "LSTMCell" \
            else (_x(3, 8, seed=1),)
    if cls == "LSTMCell" and with_state:
        res = {}
        for pkg, m in ((pt, jm), (tp, tm)):
            h = pkg.to_tensor(states[0][0])
            c = pkg.to_tensor(states[0][1])
            out, (h2, c2) = m(pkg.to_tensor(x), (h, c))
            res[pkg] = [np.asarray(t.numpy()) for t in (out, h2, c2)]
        for a, b in zip(res[tp], res[pt]):
            np.testing.assert_allclose(a, b, **VAL)
        return
    _hold(jm, tm, [x], states)
    assert tm.state_shape == jm.state_shape


def test_cell_initial_states():
    _, tm = _pair("GRUCell", 4, 5)
    s = tm.get_initial_states(3)
    assert s.shape == [3, 5] and float(s.abs().sum()) == 0.0


# ---- multi-layer nets ----------------------------------------------------------
NETS = [
    ("SimpleRNN", dict(num_layers=1)),
    ("SimpleRNN", dict(num_layers=2, activation="relu")),
    ("SimpleRNN", dict(num_layers=2, direction="bidirect")),
    ("LSTM", dict(num_layers=1)),
    ("LSTM", dict(num_layers=2, direction="bidirectional")),
    ("LSTM", dict(num_layers=2, time_major=True)),
    ("GRU", dict(num_layers=1)),
    ("GRU", dict(num_layers=2, direction="bidirect")),
    ("GRU", dict(num_layers=1, time_major=True)),
]


@pytest.mark.parametrize("cls,kw", NETS, ids=[
    f"{c}-{'-'.join(f'{k}={v}' for k, v in kw.items())}" for c, kw in NETS])
def test_nets(cls, kw):
    jm, tm = _pair(cls, 6, 8, **kw)
    x = _x(5, 3, 6) if kw.get("time_major") else _x(3, 5, 6)
    _hold(jm, tm, [x])


@pytest.mark.parametrize("cls", ["LSTM", "GRU", "SimpleRNN"])
def test_nets_with_initial_states(cls):
    jm, tm = _pair(cls, 4, 6, num_layers=2, direction="bidirect")
    x = _x(2, 7, 4)
    h0 = _x(4, 2, 6, seed=1)
    res = {}
    for pkg, m in ((pt, jm), (tp, tm)):
        init = (pkg.to_tensor(h0), pkg.to_tensor(_x(4, 2, 6, seed=2))) \
            if cls == "LSTM" else pkg.to_tensor(h0)
        out, st = m(pkg.to_tensor(x), init)
        res[pkg] = [np.asarray(t.numpy()) for t in _flat((out, st))]
    for a, b in zip(res[tp], res[pt]):
        np.testing.assert_allclose(a, b, **VAL)


def test_dropout_between_layers_only_in_training():
    """Dropout between layers draws from the port's generator (not
    compared across packages); in eval it is off and the net is the
    reference's."""
    jm, tm = _pair("LSTM", 4, 6, num_layers=2, dropout=0.5)
    x = _x(2, 5, 4)
    jm.eval()
    tm.eval()
    a = np.asarray(jm(pt.to_tensor(x))[0].numpy())
    b = tm(tp.to_tensor(x))[0].numpy()
    np.testing.assert_allclose(b, a, **VAL)
    tm.train()
    tp.seed(3)
    c = tm(tp.to_tensor(x))[0].numpy()
    tp.seed(3)
    d = tm(tp.to_tensor(x))[0].numpy()
    np.testing.assert_array_equal(c, d)
    assert not np.allclose(c, b)


def test_bad_direction_raises():
    with pytest.raises(ValueError):
        tnn.LSTM(4, 4, direction="sideways")


# ---- the generic runners ---------------------------------------------------------
@pytest.mark.parametrize("reverse", [False, True])
def test_rnn_runner_over_a_cell(reverse):
    res = {}
    for pkg, nn in ((pt, jnn), (tp, tnn)):
        pkg.seed(0)
        cell = nn.GRUCell(4, 6)
        if pkg is tp:
            cell.set_state_dict(state)
        else:
            state = {k: np.asarray(v.numpy())
                     for k, v in cell.state_dict().items()}
        rnn = nn.RNN(cell, is_reverse=reverse)
        y, h = rnn(pkg.to_tensor(_x(2, 5, 4)))
        res[pkg] = (np.asarray(y.numpy()), np.asarray(h.numpy()))
    for a, b in zip(res[tp], res[pt]):
        np.testing.assert_allclose(a, b, **VAL)


def test_birnn_over_lstm_cells():
    res = {}
    for pkg, nn in ((pt, jnn), (tp, tnn)):
        pkg.seed(0)
        fw, bw = nn.LSTMCell(4, 5), nn.LSTMCell(4, 5)
        if pkg is tp:
            fw.set_state_dict(sf)
            bw.set_state_dict(sb)
        else:
            sf = {k: np.asarray(v.numpy()) for k, v in fw.state_dict().items()}
            sb = {k: np.asarray(v.numpy()) for k, v in bw.state_dict().items()}
        y, (s_fw, s_bw) = nn.BiRNN(fw, bw)(pkg.to_tensor(_x(2, 3, 4)))
        res[pkg] = [np.asarray(t.numpy())
                    for t in _flat((y, s_fw, s_bw))]
    for a, b in zip(res[tp], res[pt]):
        np.testing.assert_allclose(a, b, **VAL)


def test_fused_layer_equals_the_cell_loop():
    """Inside the port: one fused LSTM layer and direction equals stepping
    its cell's ``_step`` over time (the gate orders are the same)."""
    _, tm = _pair("LSTM", 4, 6)
    cell = tnn.LSTMCell(4, 6)
    cell.set_state_dict({k.replace("_l0", ""): v.numpy()
                         for k, v in tm.state_dict().items()})
    x = _x(2, 5, 4)
    y, (h, c) = tm(tp.to_tensor(x))
    ys, st = tnn.RNN(cell)(tp.to_tensor(x))
    np.testing.assert_allclose(y.numpy(), ys.numpy(), **VAL)
    np.testing.assert_allclose(h.numpy()[0], st[0].numpy(), **VAL)


@pytest.mark.cuda
def test_bidirectional_nets_on_the_card_match_the_cpu():
    """A 2-layer bidirectional LSTM and GRU (cuDNN on the card) against the
    same calls on the CPU: outputs, states and gradients at 1e-4 of their
    largest (TF32 off)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    for cls in ("LSTM", "GRU"):
        tp.seed(0)
        m = getattr(tnn, cls)(16, 32, num_layers=2, direction="bidirect")
        state = {k: v.numpy() for k, v in m.state_dict().items()}
        x = _x(4, 9, 16)
        res = {}
        for dev in ("cpu", "cuda"):
            tp.set_device(dev)
            net = getattr(tnn, cls)(16, 32, num_layers=2, direction="bidirect")
            net.set_state_dict(state)
            t = tp.to_tensor(x)
            t.stop_gradient = False
            out = _flat(net(t))
            sum(o.sum() for o in out).backward()
            res[dev] = [o.numpy() for o in out] + [t.grad.numpy()] + [
                p.grad.numpy() for p in net.parameters()]
        tp.set_device("cpu")
        for a, b in zip(res["cuda"], res["cpu"]):
            assert np.abs(a - b).max() <= 1e-4 * max(np.abs(b).max(), 1e-6)
