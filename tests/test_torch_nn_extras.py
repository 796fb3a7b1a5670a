"""The port's nn extras (``paddle_tpu_torch/nn/functional/{extras,
extra_losses}.py``, ``nn/layer/extras.py``) against the JAX package's, on
the CPU.

Every functional and loss runs on both packages over the same numpy
inputs: the outputs, and the gradients of a weighted sum of them with
respect to every float input, at the reference tests' tolerances
(``tests/test_nn_surface2.py``: 1e-5 for the losses and the vision ops,
1e-4 where its golden is 1e-4).  The reference test's torch goldens are
mirrored too (torch is the port's own library, so those cases also show
where a torch library call would give the same values: ``ctc_loss``'s mean
over label lengths included).  Random draws (fractional pooling's offset,
``class_center_sample``) are the port's own and are held by their
properties.  The layers are held through their functionals, weights
handed across as numpy.  ``cuda``-marked cases hold the card against the
CPU.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as JF
import paddle_tpu_torch as tp
import paddle_tpu_torch.nn as tnn
import paddle_tpu_torch.nn.functional as F
from _torch_copies import differing_units, statement
from paddle_tpu_torch.core import device as tdevice

VAL = dict(rtol=1e-5, atol=1e-5)
LOOSE = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def on_cpu():
    prev = tdevice._current_device
    tp.set_device("cpu")
    yield
    tdevice._current_device = prev


def _rng(seed=0):
    return np.random.RandomState(seed)


def _flat(out):
    if isinstance(out, (list, tuple)):
        return [o for v in out for o in _flat(v)]
    return [] if out is None else [out]


def _both(name, arrays, tol=VAL, grad=True, **kw):
    """F.<name> over the same inputs on both packages: outputs at ``tol``,
    and the gradients of a weighted sum of the float outputs with respect
    to every float32 input.  Returns the port's outputs as numpy."""
    res = {}
    for pkg, mod in ((tp, F), (pt, JF)):
        ins = []
        for a in arrays:
            t = pkg.to_tensor(a)
            if grad and a.dtype == np.float32:
                t.stop_gradient = False
            ins.append(t)
        out = _flat(getattr(mod, name)(*ins, **kw))
        vals = [np.asarray(o.numpy()) for o in out]
        grads = []
        if grad:
            loss = None
            for k, (o, v) in enumerate(zip(out, vals)):
                if v.dtype != np.float32:
                    continue
                w = _rng(9 + k).uniform(0.5, 1.5, v.shape).astype(np.float32)
                term = (o * pkg.to_tensor(w)).sum()
                loss = term if loss is None else loss + term
            if loss is not None:
                loss.backward()
                # an input the outputs do not depend on differentiably
                # (nearest sampling's grid) has a zero gradient
                grads = [None if t.stop_gradient else
                         np.zeros(t.shape, np.float32) if t.grad is None
                         else np.asarray(t.grad.numpy()) for t in ins]
        res[pkg] = (vals, grads)
    (tv, tg), (jv, jg) = res[tp], res[pt]
    assert len(tv) == len(jv)
    for i, (a, b) in enumerate(zip(tv, jv)):
        assert a.shape == b.shape, (name, i, a.shape, b.shape)
        if np.issubdtype(b.dtype, np.floating):
            np.testing.assert_allclose(a, b, err_msg=f"{name} output {i}",
                                       **tol)
        else:
            np.testing.assert_array_equal(a, b, err_msg=f"{name} output {i}")
    for i, (a, b) in enumerate(zip(tg, jg)):
        assert (a is None) == (b is None), (name, i)
        if a is not None:
            np.testing.assert_allclose(a, b, err_msg=f"{name} grad {i}",
                                       rtol=1e-4, atol=1e-4)
    return tv


# ---- copy fidelity of the layers ---------------------------------------------
# the units of the port's nn/layer/extras.py that differ from the
# reference's: the docstring, the imports, and the beam search's tensor
# bookkeeping in torch (and its host reads)
DIVERGENT = {
    "__doc__",
    statement("import jax.numpy as jnp"), statement("import torch"),
    statement("from ...core.dispatch import unwrap"),
    "AdaptiveLogSoftmaxWithLoss.log_prob",
    "BeamSearchDecoder.initialize", "BeamSearchDecoder.step",
    "BeamSearchDecoder.finished", "dynamic_decode",
}


def test_layers_copy_matches_the_reference():
    assert differing_units("nn/layer/extras.py") == DIVERGENT


def test_surface_names():
    for name in ("poisson_nll_loss", "gaussian_nll_loss", "soft_margin_loss",
                 "multi_label_soft_margin_loss", "multi_margin_loss",
                 "triplet_margin_with_distance_loss", "dice_loss", "log_loss",
                 "npair_loss", "hsigmoid_loss", "margin_cross_entropy",
                 "ctc_loss", "rnnt_loss", "adaptive_log_softmax_with_loss",
                 "pairwise_distance", "elu_", "hardtanh_", "leaky_relu_",
                 "tanh_", "thresholded_relu_", "lp_pool1d", "lp_pool2d",
                 "fractional_max_pool2d", "fractional_max_pool3d",
                 "max_unpool3d", "affine_grid", "grid_sample",
                 "temporal_shift", "gather_tree", "class_center_sample",
                 "flashmask_attention", "flash_attn_qkvpacked",
                 "flash_attn_varlen_qkvpacked", "sparse_attention"):
        assert hasattr(F, name), name
    for name in ("CTCLoss", "RNNTLoss", "HSigmoidLoss",
                 "AdaptiveLogSoftmaxWithLoss", "Softmax2D", "Unflatten",
                 "ParameterDict", "ZeroPad1D", "ZeroPad3D", "LPPool1D",
                 "LPPool2D", "FractionalMaxPool2D", "FractionalMaxPool3D",
                 "MaxUnPool3D", "BeamSearchDecoder", "dynamic_decode",
                 "PoissonNLLLoss", "GaussianNLLLoss", "SoftMarginLoss",
                 "MultiLabelSoftMarginLoss", "MultiMarginLoss",
                 "TripletMarginWithDistanceLoss"):
        assert hasattr(tnn, name), name


# ---- the losses: against the JAX package -----------------------------------------
def _loss_inputs(name):
    r = _rng(1)
    if name == "poisson_nll_loss":
        return [r.randn(4, 5).astype(np.float32),
                r.poisson(2.0, (4, 5)).astype(np.float32)], {}
    if name == "poisson_nll_loss_full":
        return [np.abs(r.randn(4, 5)).astype(np.float32) + 0.1,
                r.poisson(3.0, (4, 5)).astype(np.float32)], dict(
                    log_input=False, full=True, reduction="sum")
    if name == "gaussian_nll_loss":
        return [r.randn(4, 5).astype(np.float32),
                r.randn(4, 5).astype(np.float32),
                r.rand(4, 5).astype(np.float32) + 0.1], dict(full=True)
    if name == "soft_margin_loss":
        return [r.randn(6).astype(np.float32),
                np.sign(r.randn(6)).astype(np.float32)], {}
    if name == "multi_label_soft_margin_loss":
        return [r.randn(3, 4).astype(np.float32),
                (r.rand(3, 4) > 0.5).astype(np.float32),
                r.rand(4).astype(np.float32)], dict(reduction="none")
    if name == "multi_margin_loss":
        return [r.randn(5, 4).astype(np.float32),
                r.randint(0, 4, 5).astype(np.int32)], dict(p=2, margin=0.5)
    if name == "triplet_margin_with_distance_loss":
        return [r.randn(4, 8).astype(np.float32) for _ in range(3)], dict(
            swap=True)
    if name == "log_loss":
        return [np.clip(r.rand(4, 1), 0.05, 0.95).astype(np.float32),
                (r.rand(4, 1) > 0.5).astype(np.float32)], {}
    if name == "npair_loss":
        return [r.randn(4, 8).astype(np.float32),
                r.randn(4, 8).astype(np.float32),
                np.array([0, 1, 0, 2], np.int32)], {}
    if name == "margin_cross_entropy":
        return [np.clip(r.randn(4, 6) * 0.3, -1, 1).astype(np.float32),
                r.randint(0, 6, 4).astype(np.int32)], dict(
                    margin1=1.0, margin2=0.5, margin3=0.1, scale=16.0,
                    return_softmax=True)
    raise KeyError(name)


LOSSES = ["poisson_nll_loss", "poisson_nll_loss_full", "gaussian_nll_loss",
          "soft_margin_loss", "multi_label_soft_margin_loss",
          "multi_margin_loss", "triplet_margin_with_distance_loss",
          "log_loss", "npair_loss", "margin_cross_entropy"]


@pytest.mark.parametrize("case", LOSSES)
def test_losses_against_the_reference(case):
    arrays, kw = _loss_inputs(case)
    name = case.replace("_full", "")
    if name == "multi_label_soft_margin_loss":
        arrays, w = arrays[:2], arrays[2]
        for weight in (None, w):
            res = []
            for pkg, mod in ((tp, F), (pt, JF)):
                extra = {} if weight is None else {
                    "weight": pkg.to_tensor(weight)}
                res.append(np.asarray(getattr(mod, name)(
                    *[pkg.to_tensor(a) for a in arrays], **kw,
                    **extra).numpy()))
            np.testing.assert_allclose(res[0], res[1], **VAL)
    _both(name, arrays, **kw)


def test_dice_loss_against_the_reference():
    r = _rng(2)
    probs = torch.softmax(torch.tensor(r.randn(2, 6, 3).astype(np.float32)),
                          -1).numpy()
    lbl = r.randint(0, 3, (2, 6, 1)).astype(np.int32)
    d = _both("dice_loss", [probs, lbl])
    assert 0 <= float(d[0]) <= 1


@pytest.mark.parametrize("lengths", [
    ((8, 7, 6), (3, 2, 1)), ((8, 8, 8), (3, 3, 3)), ((6, 6, 5), (2, 0, 1))],
    ids=["ragged", "full", "empty_target"])
@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
def test_ctc_loss_against_the_reference_and_torch(lengths, reduction):
    T, B, C, L = 8, 3, 5, 3
    r = _rng(3)
    logits = r.randn(T, B, C).astype(np.float32)
    labels = r.randint(1, C, (B, L)).astype(np.int32)
    in_len = np.array(lengths[0], np.int32)
    lab_len = np.array(lengths[1], np.int32)
    ours = _both("ctc_loss", [logits, labels, in_len, lab_len], tol=LOOSE,
                 reduction=reduction)[0]
    ref = torch.nn.functional.ctc_loss(
        torch.tensor(logits).log_softmax(-1),
        torch.tensor(labels.astype(np.int64)), torch.tensor(in_len).long(),
        torch.tensor(lab_len).long(), blank=0, reduction=reduction,
        zero_infinity=False).numpy()
    np.testing.assert_allclose(ours, ref, rtol=1e-4)


def test_ctc_norm_by_times_and_layer():
    T, B, C, L = 6, 2, 4, 2
    r = _rng(4)
    arrays = [r.randn(T, B, C).astype(np.float32),
              r.randint(1, C, (B, L)).astype(np.int32),
              np.array([6, 5], np.int32), np.array([2, 1], np.int32)]
    _both("ctc_loss", arrays, tol=LOOSE, norm_by_times=True)
    a = tnn.CTCLoss(blank=0, reduction="sum")(
        *[tp.to_tensor(x) for x in arrays])
    b = jnn.CTCLoss(blank=0, reduction="sum")(
        *[pt.to_tensor(x) for x in arrays])
    np.testing.assert_allclose(float(a), float(b), rtol=1e-4)


@pytest.mark.parametrize("fastemit", [0.0, 0.001], ids=["plain", "fastemit"])
def test_rnnt_loss_against_the_reference(fastemit):
    B, T, U, C = 2, 4, 3, 5
    r = _rng(5)
    arrays = [r.randn(B, T, U + 1, C).astype(np.float32),
              r.randint(1, C, (B, U)).astype(np.int32),
              np.array([4, 3], np.int32), np.array([3, 2], np.int32)]
    _both("rnnt_loss", arrays, tol=LOOSE, fastemit_lambda=fastemit)
    _both("rnnt_loss", arrays, tol=LOOSE, fastemit_lambda=fastemit,
          reduction="none")
    lay = tnn.RNNTLoss(fastemit_lambda=fastemit)(
        *[tp.to_tensor(x) for x in arrays])
    ref = jnn.RNNTLoss(fastemit_lambda=fastemit)(
        *[pt.to_tensor(x) for x in arrays])
    np.testing.assert_allclose(float(lay), float(ref), rtol=1e-4)


def test_rnnt_matches_bruteforce():
    """test_nn_surface2.py's brute force over every monotonic path."""
    import itertools
    import scipy.special
    B, T, U, C = 1, 3, 2, 4
    logits = _rng(6).randn(B, T, U + 1, C).astype(np.float32)
    label = np.array([[1, 2]], np.int32)
    ours = float(F.rnnt_loss(tp.to_tensor(logits), tp.to_tensor(label),
                             tp.to_tensor(np.array([T], np.int64)),
                             tp.to_tensor(np.array([U], np.int64))))
    lp = torch.tensor(logits).log_softmax(-1).numpy()[0]
    paths = []
    for positions in itertools.combinations(range(T + U), U):
        seq = ["L" if i in positions else "B" for i in range(T + U)]
        t = u = 0
        s, ok = 0.0, True
        for mv in seq:
            if mv == "L":
                if u >= U or t >= T:
                    ok = False
                    break
                s += lp[t, u, label[0, u]]
                u += 1
            else:
                if t >= T:
                    ok = False
                    break
                s += lp[t, u, 0]
                t += 1
        if ok and t == T and u == U:
            paths.append(s)
    np.testing.assert_allclose(ours, -scipy.special.logsumexp(paths),
                               rtol=1e-4)


@pytest.mark.parametrize("bias", [False, True])
def test_hsigmoid_loss_against_the_reference(bias):
    C, D, N = 8, 6, 5
    r = _rng(7)
    arrays = [r.randn(N, D).astype(np.float32),
              r.randint(0, C, (N,)).astype(np.int32),
              r.randn(C - 1, D).astype(np.float32)]
    if bias:
        arrays.append(r.randn(C - 1).astype(np.float32))
    res = {}
    for pkg, mod in ((tp, F), (pt, JF)):
        t = [pkg.to_tensor(a) for a in arrays]
        for k in (0, 2) + ((3,) if bias else ()):
            t[k].stop_gradient = False
        out = mod.hsigmoid_loss(t[0], t[1], C, t[2],
                                bias=t[3] if bias else None)
        out.sum().backward()
        res[pkg] = [np.asarray(out.numpy())] + [
            np.asarray(t[k].grad.numpy()) for k in (0, 2)]
    for a, b in zip(res[tp], res[pt]):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)


def test_hsigmoid_layer_is_normalized():
    """test_nn_surface2.py: P(c|x) sums to 1 over the classes under the
    default tree."""
    C, D = 8, 6
    tp.seed(0)
    layer = tnn.HSigmoidLoss(D, C)
    x = tp.to_tensor(_rng(8).randn(1, D).astype(np.float32))
    total = sum(float(np.exp(-layer(x, tp.to_tensor(
        np.array([c], np.int64))).numpy()).reshape(-1)[0]) for c in range(C))
    np.testing.assert_allclose(total, 1.0, rtol=1e-4)


def test_margin_cross_entropy_reduces_to_ce_at_zero_margin():
    r = _rng(9)
    cos = np.clip(r.randn(4, 6).astype(np.float32) * 0.3, -1, 1)
    lbl = r.randint(0, 6, 4)
    ours = float(F.margin_cross_entropy(tp.to_tensor(cos), tp.to_tensor(lbl),
                                        margin1=1.0, margin2=0.0, margin3=0.0,
                                        scale=10.0))
    ref = float(torch.nn.functional.cross_entropy(torch.tensor(cos * 10.0),
                                                  torch.tensor(lbl)))
    np.testing.assert_allclose(ours, ref, rtol=1e-4)


def test_adaptive_log_softmax_layer_against_the_reference():
    pt.seed(0)
    jl = jnn.AdaptiveLogSoftmaxWithLoss(16, 20, cutoffs=[4, 10],
                                        head_bias=True)
    state = {k: np.asarray(v.numpy()) for k, v in jl.state_dict().items()}
    tl = tnn.AdaptiveLogSoftmaxWithLoss(16, 20, cutoffs=[4, 10],
                                        head_bias=True)
    missing, unexpected = tl.set_state_dict(state)
    assert not missing and not unexpected
    r = _rng(10)
    x = r.randn(8, 16).astype(np.float32)
    lbl = r.randint(0, 20, 8).astype(np.int32)
    full = tl.log_prob(tp.to_tensor(x)).numpy()
    np.testing.assert_allclose(full, np.asarray(
        jl.log_prob(pt.to_tensor(x)).numpy()), **VAL)
    np.testing.assert_allclose(np.exp(full).sum(-1), np.ones(8), rtol=1e-4)
    out, loss = tl(tp.to_tensor(x), tp.to_tensor(lbl))
    jout, jloss = jl(pt.to_tensor(x), pt.to_tensor(lbl))
    np.testing.assert_allclose(out.numpy(), np.asarray(jout.numpy()), **VAL)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(out.numpy(), full[np.arange(8), lbl],
                               rtol=1e-4)
    np.testing.assert_array_equal(tl.predict(tp.to_tensor(x)).numpy(),
                                  np.asarray(jl.predict(
                                      pt.to_tensor(x)).numpy()))


@pytest.mark.parametrize("cls,kw,n_in", [
    ("PoissonNLLLoss", {}, 2), ("GaussianNLLLoss", {"full": True}, 3),
    ("SoftMarginLoss", {"reduction": "sum"}, 2),
    ("MultiLabelSoftMarginLoss", {}, 2),
    ("TripletMarginWithDistanceLoss", {"margin": 0.5}, 3)])
def test_loss_layers_against_the_reference(cls, kw, n_in):
    r = _rng(11)
    arrays = [r.rand(3, 4).astype(np.float32) + 0.1 for _ in range(n_in)]
    if cls == "SoftMarginLoss":
        arrays[1] = np.sign(arrays[1] - 0.6).astype(np.float32)
    a = getattr(tnn, cls)(**kw)(*[tp.to_tensor(x) for x in arrays])
    b = getattr(jnn, cls)(**kw)(*[pt.to_tensor(x) for x in arrays])
    np.testing.assert_allclose(a.numpy(), np.asarray(b.numpy()), **VAL)


def test_multi_margin_loss_layer_and_torch():
    r = _rng(12)
    x = r.randn(5, 4).astype(np.float32)
    y = r.randint(0, 4, 5)
    a = float(tnn.MultiMarginLoss()(tp.to_tensor(x), tp.to_tensor(y)))
    ref = float(torch.nn.functional.multi_margin_loss(torch.tensor(x),
                                                      torch.tensor(y)))
    np.testing.assert_allclose(a, ref, rtol=1e-5)


# ---- the functionals ---------------------------------------------------------------
@pytest.mark.parametrize("p,keepdim", [(2.0, False), (1.0, True), (3.0, False)])
def test_pairwise_distance(p, keepdim):
    r = _rng(13)
    a, b = r.randn(4, 6).astype(np.float32), r.randn(4, 6).astype(np.float32)
    ours = _both("pairwise_distance", [a, b], p=p, keepdim=keepdim)[0]
    if p == 2.0:
        ref = torch.nn.functional.pairwise_distance(torch.tensor(a),
                                                    torch.tensor(b)).numpy()
        np.testing.assert_allclose(ours, ref, rtol=1e-4)


def test_lp_pools_against_the_reference_and_torch():
    r = _rng(14)
    x = np.abs(r.randn(2, 3, 8).astype(np.float32)) + 0.1
    ours = _both("lp_pool1d", [x], norm_type=2, kernel_size=2)[0]
    np.testing.assert_allclose(ours, torch.nn.functional.lp_pool1d(
        torch.tensor(x), 2, 2).numpy(), rtol=1e-4)
    x2 = np.abs(r.randn(2, 3, 6, 6).astype(np.float32)) + 0.1
    ours2 = _both("lp_pool2d", [x2], norm_type=3, kernel_size=2)[0]
    np.testing.assert_allclose(ours2, torch.nn.functional.lp_pool2d(
        torch.tensor(x2), 3, 2).numpy(), rtol=1e-4)
    a = tnn.LPPool2D(3, 2)(tp.to_tensor(x2)).numpy()
    b = np.asarray(jnn.LPPool2D(3, 2)(pt.to_tensor(x2)).numpy())
    np.testing.assert_allclose(a, b, **VAL)
    a = tnn.LPPool1D(2, 2, stride=1)(tp.to_tensor(x)).numpy()
    b = np.asarray(jnn.LPPool1D(2, 2, stride=1)(pt.to_tensor(x)).numpy())
    np.testing.assert_allclose(a, b, **VAL)


@pytest.mark.parametrize("kernel", [None, 3])
def test_fractional_max_pool2d_at_a_fixed_offset(kernel):
    x = _rng(15).randn(1, 2, 9, 9).astype(np.float32)
    _both("fractional_max_pool2d", [x], output_size=4, kernel_size=kernel,
          random_u=0.5)
    out, mask = F.fractional_max_pool2d(tp.to_tensor(x), 4,
                                        kernel_size=kernel, random_u=0.5,
                                        return_mask=True)
    jout, jmask = JF.fractional_max_pool2d(pt.to_tensor(x), 4,
                                           kernel_size=kernel, random_u=0.5,
                                           return_mask=True)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask.numpy()))
    assert str(mask.numpy().dtype) == "int32"
    flat = x.reshape(1, 2, -1)
    np.testing.assert_array_equal(
        np.take_along_axis(flat, mask.numpy().reshape(1, 2, -1), 2),
        out.numpy().reshape(1, 2, -1))


def test_fractional_pools_draw_from_the_port_generator():
    """test_nn_surface2.py's properties; the offset comes from the port's
    generator, so two runs at one seed agree."""
    x = _rng(16).randn(1, 2, 9, 9).astype(np.float32)
    out = F.fractional_max_pool2d(tp.to_tensor(x), 4, random_u=0.5)
    assert out.shape == [1, 2, 4, 4] and out.numpy().max() <= x.max() + 1e-6
    ov = F.fractional_max_pool2d(tp.to_tensor(x), 4, kernel_size=3,
                                 random_u=0.5).numpy()
    assert (ov >= out.numpy() - 1e-6).all() and not np.allclose(
        ov, out.numpy())
    tp.seed(4)
    a = tnn.FractionalMaxPool2D(4)(tp.to_tensor(x)).numpy()
    tp.seed(4)
    b = tnn.FractionalMaxPool2D(4)(tp.to_tensor(x)).numpy()
    np.testing.assert_array_equal(a, b)
    x3 = _rng(17).randn(1, 1, 6, 6, 6).astype(np.float32)
    _both("fractional_max_pool3d", [x3], output_size=3, random_u=0.4)
    _both("fractional_max_pool3d", [x3], output_size=3, kernel_size=2,
          random_u=0.3)
    assert tnn.FractionalMaxPool3D(3)(tp.to_tensor(x3)).shape == [1, 1, 3, 3,
                                                                  3]
    with pytest.raises(NotImplementedError):
        F.fractional_max_pool3d(tp.to_tensor(x3), 3, return_mask=True)


def test_max_unpool3d_roundtrip_positions():
    x = _rng(18).randn(1, 1, 2, 2, 2).astype(np.float32)
    idx = np.array([[[[[0, 9], [18, 27]], [[36, 45], [54, 63]]]]], np.int32)
    u = _both("max_unpool3d", [x, idx], kernel_size=2)[0]
    assert u.shape == (1, 1, 4, 4, 4)
    np.testing.assert_allclose(
        u.reshape(-1)[[0, 9, 18, 27, 36, 45, 54, 63]], x.reshape(-1))
    # the layer, with an output size
    up = tnn.MaxUnPool3D(2, output_size=(5, 5, 5))(tp.to_tensor(x),
                                                    tp.to_tensor(idx))
    jup = jnn.MaxUnPool3D(2, output_size=(5, 5, 5))(pt.to_tensor(x),
                                                     pt.to_tensor(idx))
    assert up.shape == [1, 1, 5, 5, 5]
    np.testing.assert_allclose(up.numpy(), np.asarray(jup.numpy()), **VAL)


@pytest.mark.parametrize("align", [True, False])
def test_affine_grid(align):
    theta = _rng(20).randn(2, 2, 3).astype(np.float32)
    ours = _both("affine_grid", [theta], out_shape=(2, 3, 4, 5),
                 align_corners=align)[0]
    ref = torch.nn.functional.affine_grid(torch.tensor(theta), (2, 3, 4, 5),
                                          align_corners=align).numpy()
    np.testing.assert_allclose(ours, ref, atol=1e-5)
    with pytest.raises(NotImplementedError):
        F.affine_grid(tp.to_tensor(theta), (2, 3, 4, 5, 6))


@pytest.mark.parametrize("mode", ["bilinear", "nearest"])
@pytest.mark.parametrize("pm", ["zeros", "border", "reflection"])
@pytest.mark.parametrize("align", [True, False])
def test_grid_sample(mode, pm, align):
    r = _rng(21)
    x = r.randn(2, 3, 5, 6).astype(np.float32)
    grid = (r.rand(2, 4, 4, 2).astype(np.float32) * 3 - 1.5)   # OOB too
    ours = _both("grid_sample", [x, grid], mode=mode, padding_mode=pm,
                 align_corners=align)[0]
    if mode == "bilinear":
        ref = torch.nn.functional.grid_sample(
            torch.tensor(x), torch.tensor(grid), mode=mode, padding_mode=pm,
            align_corners=align).numpy()
        np.testing.assert_allclose(ours, ref, atol=1e-5)


def test_temporal_shift():
    x = _rng(22).randn(4, 8, 2, 2).astype(np.float32)
    out = _both("temporal_shift", [x], seg_num=2, shift_ratio=0.25)[0]
    v = x.reshape(2, 2, 8, 2, 2)
    np.testing.assert_allclose(out.reshape(2, 2, 8, 2, 2)[:, 0, :2],
                               v[:, 1, :2])
    np.testing.assert_allclose(out.reshape(2, 2, 8, 2, 2)[:, 1, 2:4],
                               v[:, 0, 2:4])


def test_gather_tree():
    r = _rng(23)
    ids = r.randint(0, 9, (5, 2, 3)).astype(np.int32)
    parents = r.randint(0, 3, (5, 2, 3)).astype(np.int32)
    out = _both("gather_tree", [ids, parents], grad=False)[0]
    assert out.shape == (5, 2, 3)


def test_class_center_sample():
    lbl = np.array([3, 7, 3, 1], np.int32)
    tp.seed(0)
    remap, sampled = F.class_center_sample(tp.to_tensor(lbl), 20, 6)
    s = sampled.numpy()
    assert len(s) == 6 and (np.sort(s) == s).all()
    assert {1, 3, 7} <= set(s.tolist())
    np.testing.assert_array_equal(s[remap.numpy()], lbl)
    assert str(remap.numpy().dtype) == "int32"
    # every class positive: no draw, the same as the reference
    r2, s2 = F.class_center_sample(tp.to_tensor(lbl), 20, 2)
    j2, js2 = JF.class_center_sample(pt.to_tensor(lbl), 20, 2)
    np.testing.assert_array_equal(r2.numpy(), np.asarray(j2.numpy()))
    np.testing.assert_array_equal(s2.numpy(), np.asarray(js2.numpy()))


@pytest.mark.parametrize("name,arg", [("elu_", {}), ("hardtanh_", {}),
                                      ("leaky_relu_", {}), ("tanh_", {}),
                                      ("thresholded_relu_", {})])
def test_inplace_activations(name, arg):
    x = np.array([-2.0, -0.5, 0.3, 2.0], np.float32)
    t, j = tp.to_tensor(x), pt.to_tensor(x)
    assert getattr(F, name)(t, **arg) is t
    getattr(JF, name)(j, **arg)
    np.testing.assert_allclose(t.numpy(), np.asarray(j.numpy()), rtol=1e-6)


# ---- attention entries -------------------------------------------------------
def test_flash_attn_qkvpacked_is_flash_attention():
    """The packed entry slices q, k, v out of [B, S, 3, H, D] and calls
    ``flash_attention`` (on the CPU the kernels' plain twins): equal to it
    on the same q, k and v, and the reference's within 2e-5."""
    qkv = _rng(24).randn(2, 128, 3, 2, 64).astype(np.float32)
    ours = _both("flash_attn_qkvpacked", [qkv], tol=dict(rtol=0, atol=2e-5),
                 causal=True)
    t = tp.to_tensor(qkv)
    direct, _ = F.flash_attention(t[:, :, 0], t[:, :, 1], t[:, :, 2],
                                  causal=True)
    np.testing.assert_array_equal(ours[0], direct.numpy())


def test_flashmask_attention_against_the_reference():
    r = _rng(25)
    q, k, v = (r.randn(2, 16, 2, 8).astype(np.float32) for _ in range(3))
    start = r.randint(4, 17, (2, 1, 16, 1)).astype(np.int32)
    _both("flashmask_attention", [q, k, v, start])
    _both("flashmask_attention", [q, k, v], causal=True)


@pytest.mark.parametrize("fn", ["flash_attn_varlen_qkvpacked",
                                "sparse_attention"])
def test_attention_refusals(fn):
    with pytest.raises(NotImplementedError):
        getattr(F, fn)(tp.to_tensor(np.zeros((1, 4, 3, 1, 8), np.float32)))


def test_flash_attn_unpadded_refuses_as_the_reference():
    from paddle_tpu_torch.nn.functional.attention import flash_attn_unpadded
    with pytest.raises(NotImplementedError, match="varlen"):
        flash_attn_unpadded()


# ---- layers ------------------------------------------------------------------
def test_softmax2d_unflatten_zeropads():
    r = _rng(26)
    x = r.randn(2, 3, 4, 4).astype(np.float32)
    s = tnn.Softmax2D()(tp.to_tensor(x)).numpy()
    np.testing.assert_allclose(s, np.asarray(
        jnn.Softmax2D()(pt.to_tensor(x)).numpy()), **VAL)
    np.testing.assert_allclose(s.sum(axis=1), np.ones((2, 4, 4)), rtol=1e-5)
    with pytest.raises(ValueError):
        tnn.Softmax2D()(tp.to_tensor(np.zeros((2, 3), np.float32)))
    u = tnn.Unflatten(1, [3, 1])(tp.to_tensor(r.randn(2, 3).astype(
        np.float32)))
    assert u.shape == [2, 3, 1]
    z1 = tnn.ZeroPad1D([1, 2])(tp.to_tensor(r.randn(1, 2, 4).astype(
        np.float32)))
    assert z1.shape == [1, 2, 7]
    y = r.randn(1, 1, 2, 2, 2).astype(np.float32)
    z3 = tnn.ZeroPad3D([1, 1, 1, 1, 1, 1])(tp.to_tensor(y))
    jz3 = jnn.ZeroPad3D([1, 1, 1, 1, 1, 1])(pt.to_tensor(y))
    np.testing.assert_array_equal(z3.numpy(), np.asarray(jz3.numpy()))


def test_parameter_dict():
    pd = tnn.ParameterDict({"a": tp.create_parameter([2, 2], "float32")})
    pd["b"] = tp.create_parameter([3], "float32")
    assert "a" in pd and len(pd) == 2 and len(list(pd.items())) == 2
    pd.update({"c": tp.create_parameter([1], "float32")})
    assert list(pd.keys()) == ["a", "b", "c"]
    assert len(list(pd.parameters())) == 3


# ---- seq2seq -------------------------------------------------------------------
def _decoders(beam):
    """A GRU cell, embedding and projection on both packages, the port's
    holding the JAX ones' weights, and their decoders."""
    V, H = 6, 8
    out = {}
    for pkg, nn in ((pt, jnn), (tp, tnn)):
        pkg.seed(0)
        cell, emb, proj = nn.GRUCell(H, H), nn.Embedding(V, H), \
            nn.Linear(H, V)
        if pkg is tp:
            for m, s in zip((cell, emb, proj), states):
                m.set_state_dict(s)
        else:
            states = [{k: np.asarray(v.numpy())
                       for k, v in m.state_dict().items()}
                      for m in (cell, emb, proj)]
        out[pkg] = (nn.BeamSearchDecoder(cell, start_token=0, end_token=V - 1,
                                         beam_size=beam, embedding_fn=emb,
                                         output_fn=proj), cell, emb, proj)
    return out


@pytest.mark.parametrize("beam", [1, 3])
def test_beam_search_against_the_reference(beam):
    decs = _decoders(beam)
    h0 = _rng(27).randn(2, 8).astype(np.float32)
    res = {}
    for pkg in (pt, tp):
        nn = jnn if pkg is pt else tnn
        ids, lp = nn.dynamic_decode(decs[pkg][0], pkg.to_tensor(h0),
                                    max_step_num=5)
        res[pkg] = (np.asarray(ids.numpy()), np.asarray(lp.numpy()))
    np.testing.assert_array_equal(res[tp][0], res[pt][0])
    np.testing.assert_allclose(res[tp][1], res[pt][1], rtol=1e-5, atol=1e-5)
    assert list(res[tp][0].shape[:2]) == [2, beam]
    assert (np.diff(res[tp][1], axis=1) <= 1e-5).all()   # best beam first


def test_beam1_equals_greedy():
    """Beam 1 is greedy decoding: each row's tokens are the argmax loop's
    until the row emits the end token (after which the decoder repeats
    it)."""
    V = 6
    dec, cell, emb, proj = _decoders(1)[tp]
    h0 = tp.to_tensor(_rng(28).randn(2, 8).astype(np.float32))
    ids, _ = tnn.dynamic_decode(dec, h0, max_step_num=5)
    tok = tp.to_tensor(np.zeros(2, np.int32))
    state = h0
    done = np.zeros(2, bool)
    for t in range(ids.shape[2]):
        out, state = cell(emb(tok), state)
        nxt = proj(out).numpy().argmax(-1)
        got = ids.numpy()[:, 0, t]
        np.testing.assert_array_equal(got[~done], nxt[~done])
        assert (got[done] == V - 1).all()
        done |= got == V - 1
        tok = tp.to_tensor(nxt.astype(np.int32))


def test_beam_search_over_lstm_states():
    """The decoder keeps a cell's own state structure (LSTM's tuple)."""
    tp.seed(0)
    cell = tnn.LSTMCell(4, 4)
    dec = tnn.BeamSearchDecoder(cell, start_token=0, end_token=3,
                                beam_size=2,
                                embedding_fn=tnn.Embedding(4, 4))
    h = tp.to_tensor(_rng(29).randn(3, 4).astype(np.float32))
    ids, lp = tnn.dynamic_decode(dec, (h, h), max_step_num=3)
    assert list(ids.shape[:2]) == [3, 2] and lp.shape == [3, 2]


# ---- the card ------------------------------------------------------------------
@pytest.mark.cuda
def test_ctc_loss_and_grid_sample_on_the_card_match_the_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    r = _rng(30)
    T, B, C, L = 50, 4, 20, 10
    arrays = [r.randn(T, B, C).astype(np.float32),
              r.randint(1, C, (B, L)).astype(np.int32),
              np.array([50, 45, 40, 30], np.int32),
              np.array([10, 8, 5, 1], np.int32)]
    x = r.randn(2, 3, 16, 16).astype(np.float32)
    grid = r.rand(2, 8, 8, 2).astype(np.float32) * 2.2 - 1.1
    res = {}
    for dev in ("cpu", "cuda"):
        tp.set_device(dev)
        lp = tp.to_tensor(arrays[0])
        lp.stop_gradient = False
        loss = F.ctc_loss(lp, *[tp.to_tensor(a) for a in arrays[1:]])
        loss.backward()
        xi = tp.to_tensor(x)
        xi.stop_gradient = False
        g = F.grid_sample(xi, tp.to_tensor(grid))
        g.sum().backward()
        res[dev] = [loss.numpy(), lp.grad.numpy(), g.numpy(),
                    xi.grad.numpy()]
    tp.set_device("cpu")
    for a, b in zip(res["cuda"], res["cpu"]):
        assert np.abs(a - b).max() <= 1e-4 * max(np.abs(b).max(), 1e-6)


@pytest.mark.cuda
def test_flash_attn_qkvpacked_on_the_card_is_flash_attention():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from paddle_tpu_torch.ops.flash_attention import flash_attention_bshd
    tp.set_device("cuda")
    try:
        qkv = tp.to_tensor(_rng(31).randn(2, 256, 3, 4, 64).astype(
            np.float32)).astype("bfloat16")
        before = flash_attention_bshd.launches_fwd
        packed, _ = F.flash_attn_qkvpacked(qkv, causal=True)
        direct, _ = F.flash_attention(qkv[:, :, 0], qkv[:, :, 1],
                                      qkv[:, :, 2], causal=True)
        assert flash_attention_bshd.launches_fwd == before + 2
        assert torch.equal(packed._buf, direct._buf)
    finally:
        tp.set_device("cpu")
