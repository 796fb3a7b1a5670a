"""Recompute (``distributed/fleet/recompute.py``) against the JAX
package's (``TestRecompute``) and against the plain step.

``recompute`` runs on ``torch.utils.checkpoint`` (non-reentrant) with the
port's generator states replayed: its gradients equal the plain block's
(and the reference's, from the same weights, at 1e-5), dropout's mask is
the forward's in the recomputation, and GPT-2's ``use_recompute`` step is
bitwise the plain step (dropout 0) with the same weights."""
import numpy as np
import pytest

import paddle_tpu as pt
import paddle_tpu.nn as jnn
import paddle_tpu_torch as tp
import paddle_tpu_torch.nn as tnn
from paddle_tpu_torch.core import device as tdevice
from paddle_tpu_torch.distributed.fleet import recompute as trc

TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def on_cpu():
    prev = tdevice._current_device
    tp.set_device("cpu")
    yield
    tdevice._current_device = prev


def _weights():
    rng = np.random.RandomState(10)
    return {"0.weight": rng.randn(8, 32).astype(np.float32) * 0.3,
            "0.bias": rng.randn(32).astype(np.float32) * 0.1,
            "1.weight": rng.randn(32, 8).astype(np.float32) * 0.3,
            "1.bias": rng.randn(8).astype(np.float32) * 0.1}


def _run(pkg, nn, rc, use):
    w = _weights()
    lin1, lin2 = nn.Linear(8, 32), nn.Linear(32, 8)
    for lin, i in ((lin1, 0), (lin2, 1)):
        lin.set_state_dict({"weight": pkg.to_tensor(w[f"{i}.weight"]),
                            "bias": pkg.to_tensor(w[f"{i}.bias"])})

    def block(x):
        return lin2(pkg.tanh(lin1(x)))
    x = pkg.to_tensor(np.random.RandomState(1).rand(4, 8).astype(np.float32),
                      stop_gradient=False)
    out = rc(block, x) if use else block(x)
    (out * out).sum().backward()
    return [np.asarray(t.numpy()) for t in
            (out, x.grad, lin1.weight.grad, lin1.bias.grad, lin2.weight.grad)]


def test_recompute_matches_plain_and_reference():
    from paddle_tpu.distributed.fleet.recompute import recompute as jrc
    got = _run(tp, tnn, trc.recompute, True)
    plain = _run(tp, tnn, trc.recompute, False)
    ref = _run(pt, jnn, jrc, True)
    for a, b, c in zip(got, plain, ref):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_allclose(a, c, rtol=TOL, atol=TOL)


def test_recompute_preserves_dropout_rng():
    """reference TestRecompute.test_recompute_preserves_dropout_rng: the
    recomputation draws the forward's mask."""
    tp.seed(11)
    drop = tnn.Dropout(0.5)

    def block(x):
        return drop(x) * 2
    x = tp.to_tensor(np.ones((64,), np.float32), stop_gradient=False)
    out = trc.recompute(block, x)
    out.backward(tp.ones([64]))
    fwd, grad = out.numpy(), x.grad.numpy()
    np.testing.assert_allclose((fwd > 0).astype(np.float32) * 4.0, grad)
    assert 0 < (fwd > 0).sum() < 64


def test_recompute_leaves_the_generator_where_the_forward_left_it():
    """After the backward's replay the next draw is the one a plain
    forward and backward would give."""
    draws = []
    for use in (True, False):
        tp.seed(5)
        drop = tnn.Dropout(0.5)
        x = tp.to_tensor(np.ones((32,), np.float32), stop_gradient=False)
        out = trc.recompute(drop, x) if use else drop(x)
        out.sum().backward()
        draws.append(tp.rand([4]).numpy())
    np.testing.assert_array_equal(draws[0], draws[1])


def test_recompute_without_grad_runs_under_no_grad():
    lin = tnn.Linear(4, 4)
    x = tp.to_tensor(np.ones((2, 4), np.float32))
    out = trc.recompute(lin, x)
    assert out.stop_gradient
    with tp.no_grad():
        y = trc.recompute(lin, tp.to_tensor(np.ones((2, 4), np.float32),
                                            stop_gradient=False))
    assert y.stop_gradient


def test_recompute_tuple_outputs_and_non_tensor_args():
    lin = tnn.Linear(4, 4)

    def f(x, scale, flag):
        h = lin(x) * scale
        return h, (h.sum() if flag else None), 7
    x = tp.to_tensor(np.random.RandomState(2).rand(2, 4).astype(np.float32),
                     stop_gradient=False)
    h, s, seven = trc.recompute(f, x, 3.0, True)
    assert seven == 7 and not h.stop_gradient
    (h.sum() + s).backward()
    g1 = x.grad.numpy().copy()
    x.clear_grad()
    h2, s2, _ = f(x, 3.0, True)
    (h2.sum() + s2).backward()
    np.testing.assert_allclose(g1, x.grad.numpy(), rtol=1e-6)


def test_recompute_sequential_and_hybrid_match_plain():
    tp.seed(3)
    layers = [tnn.Linear(8, 8) for _ in range(4)]
    x0 = np.random.RandomState(4).rand(2, 8).astype(np.float32)
    outs = []
    for how in ("plain", "sequential", "hybrid"):
        for l in layers:
            for p in l.parameters():
                p.clear_grad()
        x = tp.to_tensor(x0, stop_gradient=False)
        if how == "plain":
            y = x
            for l in layers:
                y = l(y)
        elif how == "sequential":
            y = trc.recompute_sequential({"segments": 2}, layers, x)
        else:
            y = trc.recompute_hybrid({}, lambda a: layers[1](layers[0](a)), x)
            y = layers[3](layers[2](y))
        y.sum().backward()
        outs.append((y.numpy(), x.grad.numpy(),
                     layers[0].weight.grad.numpy()))
    for o in outs[1:]:
        for a, b in zip(o, outs[0]):
            np.testing.assert_allclose(a, b, rtol=1e-6)


def test_fleet_utils_reexports_recompute():
    from paddle_tpu_torch.distributed.fleet import utils
    assert utils.recompute is trc.recompute
    assert utils.recompute_sequential is trc.recompute_sequential
    from paddle_tpu_torch.parallel import sequence_parallel
    assert utils.sequence_parallel_utils is sequence_parallel
    assert utils.sequence_parallel_utils.ColumnSequenceParallelLinear is \
        sequence_parallel.ColumnSequenceParallelLinear


@pytest.mark.parametrize("dropout", [0.0, 0.1], ids=["no_dropout", "dropout"])
def test_gpt2_use_recompute_matches_the_plain_step(dropout):
    """GPT-2's ``use_recompute``: the same loss and gradients as the plain
    step from the same weights and generator state (bitwise here)."""
    from paddle_tpu_torch.models.gpt2 import GPT2Config, GPT2ForCausalLM
    res = []
    ids = np.random.RandomState(0).randint(0, 256, (2, 17))
    for remat in (False, True):
        tp.seed(0)
        cfg = GPT2Config(vocab_size=256, hidden_size=64, num_layers=2,
                         num_heads=2, max_position_embeddings=64,
                         hidden_dropout_prob=dropout,
                         attention_dropout_prob=dropout,
                         use_recompute=remat)
        m = GPT2ForCausalLM(cfg)
        m.train()
        _, loss = m(tp.to_tensor(ids[:, :-1]), labels=tp.to_tensor(ids[:, 1:]))
        loss.backward()
        res.append((float(loss), {n: p.grad.numpy() for n, p in
                                  m.named_parameters()}))
    assert res[0][0] == res[1][0]
    for n, g in res[0][1].items():
        np.testing.assert_array_equal(res[1][1][n], g, err_msg=n)
