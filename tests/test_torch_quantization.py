"""The port's quantization (M10: ``paddle_tpu_torch/quantization/`` and
``nn.quant``'s QAT layers) against the JAX package's on the CPU.

Every test of ``tests/test_quantization.py`` but ``TestQuantMatmulKernel``
(``tests/test_torch_weight_only.py`` holds K8) runs on the port, each also
held to the JAX package on the same numpy inputs and weights.  Tolerances:

- ``fake_quant`` forward at the reference's rtol 1e-6, its straight-through
  gradient exactly;
- observer thresholds and scales equal (the same float32 / numpy
  arithmetic); ``from_float``'s int8 weights and scales bit for bit;
- float32 outputs of quantized models at rtol 1e-5 / atol 1e-6, and the
  reference's 5 % bar (largest error over the float model's largest
  output) for int8 against float;
- a QAT ``Sequential`` trained five SGD steps on both: losses at rtol
  1e-5, parameters and EMA scales at rtol 1e-5 / atol 1e-6 (float32
  accumulation order is the only difference);
- the ``to_static`` QAT step bitwise the port's own eager twin.

The copies (``quantization/{base,config,observers,quanters,qat_layers,
quantize,__init__}.py``, ``nn/quant/__init__.py``): ASTs held to the
reference's but the units ``DIVERGENT`` lists.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu.nn as jnn
from paddle_tpu import quantization as JQ
import paddle_tpu_torch as tp
import paddle_tpu_torch.nn as nn
from paddle_tpu_torch import quantization as Q
from _torch_copies import differing_units, statement
from paddle_tpu_torch.core import device as tdevice

rng = np.random.RandomState(0)
OUT = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(autouse=True, scope="module")
def on_cpu():
    prev = tdevice._current_device
    tp.set_device("cpu")
    yield
    tdevice._current_device = prev


def _np(t):
    return t.numpy() if hasattr(t, "numpy") else np.asarray(t)


def _mlp(pkg, mod, seed, sizes=(8, 16, 4)):
    """Linear-ReLU-Linear on ``pkg``; the port's takes the JAX one's
    weights when ``seed`` builds the JAX one first (``_pair``)."""
    pkg.seed(seed)
    return mod.Sequential(mod.Linear(sizes[0], sizes[1]), mod.ReLU(),
                          mod.Linear(sizes[1], sizes[2]))


def _pair(seed=3, sizes=(8, 16, 4)):
    jm = _mlp(pt, jnn, seed, sizes)
    tm = _mlp(tp, nn, seed, sizes)
    state = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    assert tm.set_state_dict(state) == ([], [])
    return jm, tm


def _kinds(model):
    return [type(l).__name__ for l in model.sublayers()]


# ---- copies -----------------------------------------------------------------
DIVERGENT = {
    "quantization/base.py": {
        "__doc__", statement("import torch"),
        statement("from functools import partial"),
        statement("import jax"), statement("import jax.numpy as jnp"),
        # jax.custom_vjp -> torch.autograd.Function
        "fake_quant", "_fq_fwd", "_fq_bwd", "_FakeQuant",
        statement("fake_quant.defvjp(_fq_fwd, _fq_bwd)")},
    "quantization/config.py": set(),
    "quantization/observers.py": {
        "__doc__", statement("import jax.numpy as jnp"),
        statement("import torch"),
        statement("from ..metric import _host"),
        "AbsmaxObserverLayer.forward", "AbsmaxObserverLayer.scales",
        "PerChannelAbsmaxObserverLayer.forward",
        "PerChannelAbsmaxObserverLayer.scales",
        "HistObserverLayer.forward", "HistObserverLayer.scales",
        "KLObserverLayer.scales"},
    "quantization/quanters.py": {
        "__doc__", statement("import jax.numpy as jnp"),
        statement("import numpy as np"), statement("import torch"),
        # the EMA reads its input detached (state, not tape)
        "FakeQuanterWithAbsMaxObserverLayer.__init__",
        "FakeQuanterWithAbsMaxObserverLayer.forward",
        "FakeQuanterChannelWiseAbsMaxLayer.forward",
        "FakeQuanterChannelWiseAbsMaxLayer.scales"},
    "quantization/qat_layers.py": {
        "__doc__", statement("import jax.numpy as jnp"),
        statement("import torch"),
        "QuantizedLinearInfer.from_float", "QuantizedLinearInfer.forward",
        "QuantizedConv2DInfer.from_float", "QuantizedConv2DInfer.forward"},
    "quantization/quantize.py": set(),
    "quantization/__init__.py": {"__doc__"},
    "nn/quant/__init__.py": set(),
}


@pytest.mark.parametrize("path", sorted(DIVERGENT))
def test_copy_matches_the_reference(path):
    assert differing_units(path) == DIVERGENT[path]


def test_public_surface_is_the_references():
    assert Q.__all__ == JQ.__all__
    assert all(hasattr(Q, n) for n in Q.__all__)
    from paddle_tpu_torch.nn import quant as tquant
    from paddle_tpu.nn import quant as jquant
    assert tquant.__all__ == jquant.__all__
    assert tquant.QuantedLinear is Q.QuantedLinear
    assert tquant.QuantedConv2D is Q.QuantedConv2D
    assert Q.AbsmaxQuantizer is Q.AbsmaxObserver
    assert Q.KLQuantizer is Q.KLObserver


# ---- TestFakeQuant -------------------------------------------------------------
@pytest.mark.parametrize("scale", [2.0, 0.0, "per_channel"])
def test_fake_quant_forward_matches_numpy_and_the_reference(scale):
    x = rng.randn(4, 16).astype(np.float32)
    s = (np.abs(x).max(0, keepdims=True) if scale == "per_channel"
         else np.float32(scale))
    got = Q.fake_quant(x, s, 127.0).numpy()
    want = JQ.fake_quant(x, s, 127.0)
    sc = np.maximum(s, 1e-9).astype(np.float32)
    num = np.clip(np.round(x / sc * 127.0), -127.0, 127.0) / 127.0 * sc
    np.testing.assert_allclose(got, num, rtol=1e-6)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-6)


def test_fake_quant_bf16_forward_matches_the_reference():
    x = rng.randn(64).astype(np.float32)
    got = Q.fake_quant(torch.tensor(x).bfloat16(), torch.tensor(1.5),
                       127.0).float().numpy()
    want = np.asarray(JQ.fake_quant(jnp.asarray(x, jnp.bfloat16),
                                    jnp.float32(1.5), 127.0)
                      .astype(jnp.float32))
    np.testing.assert_allclose(got, want, rtol=1e-2)
    assert np.mean(got == want) > 0.95


def test_ste_gradient_clips_out_of_range():
    xv = np.asarray([0.5, 3.0, -0.2, -5.0, 1.0, -1.0], np.float32)
    x = torch.tensor(xv, requires_grad=True)
    s = torch.tensor(1.0, requires_grad=True)
    Q.fake_quant(x, s, 127.0).sum().backward()
    want = jax.grad(lambda a: JQ.fake_quant(a, 1.0, 127.0).sum())(
        jnp.asarray(xv))
    assert x.grad.tolist() == [1, 0, 1, 0, 1, 1]
    np.testing.assert_array_equal(x.grad.numpy(), np.asarray(want))
    assert s.grad.item() == 0.0          # no gradient to the scale
    # per-channel: the gradient's mask is per element against its column
    xs = torch.tensor(rng.randn(3, 4).astype(np.float32), requires_grad=True)
    sc = torch.tensor([[0.5, 1.0, 2.0, 0.1]], requires_grad=True)
    (Q.fake_quant(xs, sc, 7.0) * 3.0).sum().backward()
    assert torch.equal(xs.grad, 3.0 * (xs.abs() <= sc).float())
    assert torch.equal(sc.grad, torch.zeros_like(sc))


def test_quanter_layer_updates_ema_scale():
    seen = []
    for pkg, mod in ((tp, Q), (pt, JQ)):
        qt = mod.FakeQuanterWithAbsMaxObserverLayer(moving_rate=0.5)
        x = pkg.to_tensor(np.array([1.0, -4.0], np.float32))
        qt(x)
        s1 = float(qt.scales())
        assert s1 > 0
        qt(pkg.to_tensor(np.array([8.0, 0.0], np.float32)))
        s2 = float(qt.scales())
        assert s2 > s1
        qt.eval()
        qt(pkg.to_tensor(np.array([100.0], np.float32)))
        assert float(qt.scales()) == s2
        seen.append((s1, s2, float(qt.state)))
    assert seen[0] == seen[1]


# ---- TestQAT ------------------------------------------------------------------
def test_quantize_replaces_linears():
    _, model = _pair()
    cfg = Q.QuantConfig(activation=Q.FakeQuanterWithAbsMaxObserver(),
                        weight=Q.FakeQuanterWithAbsMaxObserver())
    qmodel = Q.QAT(cfg).quantize(model)
    assert _kinds(qmodel).count("QuantedLinear") == 2
    assert "QuantedLinear" not in _kinds(model)
    # the quanted layer shares its (copied) float layer's parameters
    assert qmodel[0].weight is qmodel[0]._float_layer.weight
    assert qmodel[0].weight is not model[0].weight


def test_qat_trains_and_tracks_float():
    _, model = _pair()
    cfg = Q.QuantConfig(activation=Q.FakeQuanterWithAbsMaxObserver(),
                        weight=Q.FakeQuanterWithAbsMaxObserver())
    qmodel = Q.QAT(cfg).quantize(model)
    opt = tp.optimizer.Adam(learning_rate=1e-2,
                            parameters=qmodel.parameters())
    r = np.random.RandomState(1)
    x = r.rand(32, 8).astype(np.float32)
    y = x @ r.rand(8, 4).astype(np.float32)
    losses = []
    for _ in range(40):
        loss = ((qmodel(tp.to_tensor(x)) - tp.to_tensor(y)) ** 2).mean()
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss))
    assert losses[-1] < losses[0] * 0.3, (losses[0], losses[-1])


def _qat_run(pkg, mod, Qm, model, steps, x, y, weight_factory):
    cfg = Qm.QuantConfig(activation=Qm.FakeQuanterWithAbsMaxObserver(),
                         weight=weight_factory(Qm))
    qmodel = Qm.QAT(cfg).quantize(model)
    opt = pkg.optimizer.SGD(learning_rate=0.05,
                            parameters=qmodel.parameters())
    losses = []
    for _ in range(steps):
        loss = ((qmodel(pkg.to_tensor(x)) - pkg.to_tensor(y)) ** 2).mean()
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss))
    scales = [np.asarray(_np(l.scale)) for l in qmodel.sublayers()
              if type(l).__name__ == "FakeQuanterWithAbsMaxObserverLayer"]
    params = [_np(p) for p in qmodel.parameters()]
    return qmodel, losses, scales, params


@pytest.mark.parametrize("weight", ["ema", "channel_wise"])
def test_qat_sequential_trains_like_the_reference(weight):
    """Five SGD steps of the same QAT model on both packages: losses,
    every parameter and every EMA scale agree."""
    factory = {"ema": lambda m: m.FakeQuanterWithAbsMaxObserver(),
               "channel_wise": lambda m: m.FakeQuanterChannelWiseAbsMax()}[
        weight]
    jm, tm = _pair(seed=11)
    r = np.random.RandomState(2)
    x = r.rand(16, 8).astype(np.float32)
    y = x @ r.rand(8, 4).astype(np.float32)
    _, tl, ts, tparams = _qat_run(tp, nn, Q, tm, 5, x, y, factory)
    _, jl, js, jparams = _qat_run(pt, jnn, JQ, jm, 5, x, y, factory)
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert len(ts) == len(js) > 0
    for a, b in zip(ts, js):
        np.testing.assert_allclose(a, b, **OUT)
    for a, b in zip(tparams, jparams):
        np.testing.assert_allclose(a, b, **OUT)
    assert tl[-1] < tl[0]


def test_convert_produces_int8_close_outputs():
    jm, tm = _pair()
    x = rng.rand(4, 8).astype(np.float32)
    infers = []
    for pkg, mod, model in ((tp, Q, tm), (pt, JQ, jm)):
        cfg = mod.QuantConfig(activation=None,
                              weight=mod.FakeQuanterWithAbsMaxObserver())
        qmodel = mod.QAT(cfg).quantize(model)
        qmodel(pkg.to_tensor(x))  # populate scales
        infer = mod.QAT(cfg).convert(qmodel)
        assert _kinds(infer).count("QuantizedLinearInfer") == 2
        ref = model(pkg.to_tensor(x)).numpy()
        got = infer(pkg.to_tensor(x)).numpy()
        err = np.abs(got - ref).max() / (np.abs(ref).max() + 1e-9)
        assert err < 0.05, err
        infers.append((infer, got))
    (ti, tout), (ji, jout) = infers
    for a, b in zip(ti.sublayers(), ji.sublayers()):
        if type(a).__name__ == "QuantizedLinearInfer":
            assert a.qweight._data.dtype == torch.int8
            np.testing.assert_array_equal(a.qweight.numpy(),
                                          np.asarray(b.qweight._data))
            np.testing.assert_array_equal(a.scale.numpy(),
                                          np.asarray(b.scale._data))
    np.testing.assert_allclose(tout, jout, **OUT)


# ---- TestPTQ ------------------------------------------------------------------
def test_calibrate_then_convert():
    jm, tm = _pair(seed=4)
    calib_data = [rng.rand(16, 8).astype(np.float32) for _ in range(4)]
    x = rng.rand(4, 8).astype(np.float32)
    outs = []
    for pkg, mod, model in ((tp, Q, tm), (pt, JQ, jm)):
        cfg = mod.QuantConfig(activation=mod.AbsmaxObserver(),
                              weight=mod.PerChannelAbsmaxObserver(
                                  quant_axis=1))
        ptq = mod.PTQ(cfg)
        calib = ptq.quantize(model)
        assert _kinds(calib).count("ObserveWrapper") == 2
        for d in calib_data:
            calib(pkg.to_tensor(d))
        acts = [float(l._observer.scales()) for l in calib.sublayers()
                if type(l).__name__ == "ObserveWrapper"]
        infer = ptq.convert(calib)
        assert _kinds(infer).count("QuantizedLinearInfer") == 2
        ref = model(pkg.to_tensor(x)).numpy()
        got = infer(pkg.to_tensor(x)).numpy()
        err = np.abs(got - ref).max() / (np.abs(ref).max() + 1e-9)
        assert err < 0.05, err
        outs.append((acts, [(_np(l.qweight), _np(l.scale))
                            for l in infer.sublayers()
                            if type(l).__name__ == "QuantizedLinearInfer"],
                     got))
    (ta, tq, tg), (ja, jq, jg) = outs
    assert ta == ja
    for (a, s), (b, u) in zip(tq, jq):
        np.testing.assert_array_equal(a, np.asarray(b))
        np.testing.assert_array_equal(s, np.asarray(u))
    np.testing.assert_allclose(tg, jg, **OUT)


def test_hist_and_kl_observers():
    data = rng.randn(4096).astype(np.float32)
    data[0] = 50.0  # outlier the percentile threshold should ignore
    got = {}
    for pkg, mod in ((tp, Q), (pt, JQ)):
        h = mod.HistObserverLayer(percentile=0.999)
        h(pkg.to_tensor(data))
        k = mod.KLObserverLayer()
        k(pkg.to_tensor(data))
        got[pkg] = (float(h.scales()), float(k.scales()))
    s, sk = got[tp]
    assert 2.0 < s < 10.0, s
    assert 1.0 < sk < 51.0, sk
    assert got[tp] == got[pt]


@pytest.mark.parametrize("kind", ["absmax", "per_channel_0", "per_channel_1",
                                  "hist", "kl", "hist_rebinned"])
def test_observer_scales_equal_the_references(kind):
    """Each observer over the same batches: its scales equal the JAX
    package's (per channel: elementwise; the histogram ones re-binned as
    the range grows)."""
    batches = [(np.random.RandomState(i).randn(6, 5) * (i + 1)).astype(
        np.float32) for i in range(3)]
    res = []
    for pkg, mod in ((tp, Q), (pt, JQ)):
        if kind == "absmax":
            o = mod.AbsmaxObserverLayer()
        elif kind.startswith("per_channel"):
            o = mod.PerChannelAbsmaxObserverLayer(quant_axis=int(kind[-1]))
        elif kind == "kl":
            o = mod.KLObserverLayer(bins=256)
        else:
            o = mod.HistObserverLayer(bins=128 if kind == "hist" else 32,
                                      percentile=0.99)
        for b in batches:
            out = o(pkg.to_tensor(b))
            np.testing.assert_array_equal(_np(out), b)    # identity
        res.append(np.asarray(_np(o.scales())))
    assert res[0].dtype == np.float32 and res[0].shape == res[1].shape
    np.testing.assert_array_equal(res[0], res[1])


# ---- TestWeightOnly (the functions of an earlier slice, here for the mirror)
def test_int8_roundtrip_and_linear():
    w = rng.randn(32, 16).astype(np.float32)
    qw, s = Q.weight_quantize(tp.to_tensor(w))
    jqw, js = JQ.weight_quantize(pt.to_tensor(w))
    assert qw._data.dtype == torch.int8
    np.testing.assert_array_equal(qw.numpy(), np.asarray(jqw._data))
    wd = Q.weight_dequantize(qw, s).numpy()
    assert np.abs(wd - w).max() < np.abs(w).max() / 100
    x = rng.randn(4, 32).astype(np.float32)
    y = Q.weight_only_linear(tp.to_tensor(x), qw, weight_scale=s).numpy()
    rel = np.abs(y - x @ w).max() / (np.abs(x @ w).max() + 1e-9)
    assert rel < 0.02, rel


def test_int4_pack_roundtrip():
    w = rng.randn(32, 8).astype(np.float32)
    qw, s = Q.weight_quantize(tp.to_tensor(w), algo="weight_only_int4")
    assert qw.shape == [16, 8]
    wd = Q.weight_dequantize(qw, s, algo="weight_only_int4").numpy()
    assert wd.shape == (32, 8)
    assert np.abs(wd - w).max() / np.abs(w).max() < 0.2
    x = rng.randn(4, 32).astype(np.float32)
    y = Q.weight_only_linear(tp.to_tensor(x), qw, weight_scale=s,
                             weight_dtype="int4").numpy()
    np.testing.assert_allclose(y, x @ wd, rtol=1e-4, atol=1e-4)


def test_nn_quant_namespace():
    from paddle_tpu_torch.nn.quant import weight_only_linear as wol
    assert wol is Q.weight_only_linear


# ---- TestReviewRegressions ----------------------------------------------------
def test_name_config_selects_layers():
    tp.seed(6)
    model = nn.Sequential(nn.Linear(4, 4), nn.Linear(4, 2))
    cfg = Q.QuantConfig()
    cfg.add_name_config("0", weight=Q.FakeQuanterWithAbsMaxObserver())
    kinds = _kinds(Q.QAT(cfg).quantize(model))
    assert kinds.count("QuantedLinear") == 1, kinds
    cfg = Q.QuantConfig()
    cfg.add_layer_config(model[1], weight=Q.FakeQuanterWithAbsMaxObserver())
    qm = Q.QAT(cfg).quantize(model, inplace=True)
    assert qm is model and type(model[1]).__name__ == "QuantedLinear"
    assert type(model[0]).__name__ == "Linear"


def _channelwise_step(pkg, Qm, model, x, y):
    cfg = Qm.QuantConfig(activation=None,
                         weight=Qm.FakeQuanterChannelWiseAbsMax(quant_axis=1))
    qmodel = Qm.QAT(cfg).quantize(model)
    opt = pkg.optimizer.SGD(learning_rate=1e-2,
                            parameters=qmodel.parameters())

    def step(a, b):
        loss = ((qmodel(a) - b) ** 2).mean()
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss
    return cfg, qmodel, step


def test_channelwise_qat_capture_then_convert():
    jm, tm = _pair(seed=7, sizes=(8, 8, 4))
    x = rng.rand(4, 8).astype(np.float32)
    y = rng.rand(4, 4).astype(np.float32)
    res = []
    for pkg, Qm, model in ((tp, Q, tm), (pt, JQ, jm)):
        cfg, qmodel, step = _channelwise_step(pkg, Qm, model, x, y)
        sstep = pkg.jit.to_static(step)
        xt, yt = pkg.to_tensor(x), pkg.to_tensor(y)
        losses = [float(sstep(xt, yt)) for _ in range(3)]
        infer = Qm.QAT(cfg).convert(qmodel)
        assert _kinds(infer).count("QuantizedLinearInfer") == 2
        ref = qmodel(xt).numpy()
        got = infer(xt).numpy()
        np.testing.assert_allclose(got, ref, rtol=1e-2, atol=1e-2)
        res.append((losses, got))
    np.testing.assert_allclose(res[0][0], res[1][0], rtol=1e-5)
    np.testing.assert_allclose(res[0][1], res[1][1], **OUT)


def test_wrong_axis_per_channel_scales_raise():
    for pkg, mod in ((tp, Q), (pt, JQ)):
        with pytest.raises(ValueError, match="OUTPUT channel"):
            mod.QuantizedLinearInfer.from_float(
                pkg.to_tensor(rng.rand(4, 8).astype(np.float32)), None,
                pkg.to_tensor(np.ones(4, np.float32)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("scales", ["none", "per_channel", "per_tensor"])
def test_from_float_is_bitwise_the_references(dtype, scales):
    """``QuantizedLinearInfer.from_float``: the same division,
    half-to-even rounding and clip give the reference's int8 weights and
    float32 scales bit for bit."""
    w = (rng.randn(24, 10) * 0.3).astype(np.float32)
    w[3, 2] = 0.5 * 0.3          # lands on a rounding tie for some scales
    sc = {"none": None,
          "per_channel": (np.abs(w).max(0) * 1.1).astype(np.float32),
          "per_tensor": np.float32(np.abs(w).max())}[scales]
    got = Q.QuantizedLinearInfer.from_float(
        tp.to_tensor(w).astype(dtype), None,
        None if sc is None else tp.to_tensor(sc))
    want = JQ.QuantizedLinearInfer.from_float(
        pt.to_tensor(w).astype(dtype), None,
        None if sc is None else pt.to_tensor(sc))
    assert got.qweight._data.dtype == torch.int8
    assert got.scale._data.dtype == torch.float32
    np.testing.assert_array_equal(got.qweight.numpy(),
                                  np.asarray(want.qweight._data))
    np.testing.assert_array_equal(got.scale.numpy(),
                                  np.asarray(want.scale._data))
    x = rng.rand(3, 24).astype(np.float32)
    np.testing.assert_allclose(got(tp.to_tensor(x).astype(dtype)).numpy(),
                               np.asarray(want(pt.to_tensor(x).astype(dtype))
                                          .astype("float32")._data),
                               rtol=1e-5 if dtype == "float32" else 1e-2,
                               atol=1e-6 if dtype == "float32" else 1e-2)


def test_conv2d_ptq_converts_to_int8():
    pt.seed(8)
    jmodel = jnn.Sequential(jnn.Conv2D(3, 8, 3, padding=1), jnn.ReLU())
    tmodel = nn.Sequential(nn.Conv2D(3, 8, 3, padding=1), nn.ReLU())
    tmodel.set_state_dict({k: np.asarray(v.numpy())
                           for k, v in jmodel.state_dict().items()})
    x = rng.rand(2, 3, 8, 8).astype(np.float32)
    res = []
    for pkg, mod, model in ((tp, Q, tmodel), (pt, JQ, jmodel)):
        cfg = mod.QuantConfig(activation=mod.AbsmaxObserver(),
                              weight=mod.PerChannelAbsmaxObserver(
                                  quant_axis=0))
        ptq = mod.PTQ(cfg)
        calib = ptq.quantize(model)
        calib(pkg.to_tensor(x))
        infer = ptq.convert(calib)
        assert _kinds(infer).count("QuantizedConv2DInfer") == 1
        layer = [l for l in infer.sublayers()
                 if type(l).__name__ == "QuantizedConv2DInfer"][0]
        ref = model(pkg.to_tensor(x)).numpy()
        got = infer(pkg.to_tensor(x)).numpy()
        err = np.abs(got - ref).max() / (np.abs(ref).max() + 1e-9)
        assert err < 0.05, err
        res.append((_np(layer.qweight), _np(layer.scale), got))
        # a bf16 input: the reference's conv refuses the mixed operands,
        # and so does the port's
        with pytest.raises(TypeError, match="same dtypes"):
            infer(pkg.to_tensor(x).astype("bfloat16"))
    assert res[0][0].dtype == np.int8
    np.testing.assert_array_equal(res[0][0], np.asarray(res[1][0]))
    np.testing.assert_array_equal(res[0][1], np.asarray(res[1][1]))
    np.testing.assert_allclose(res[0][2], res[1][2], **OUT)


def test_hist_observer_memory_is_bounded():
    data = [(np.random.RandomState(20 + i).rand(1000) * (i + 1)).astype(
        np.float32) for i in range(5)]
    res = []
    for pkg, mod in ((tp, Q), (pt, JQ)):
        h = mod.HistObserverLayer(bins=64)
        for d in data:
            h(pkg.to_tensor(d))
        assert h._hist.shape == (64,)
        assert abs(h._hist.sum() - 5000) < 1.0
        s = float(h.scales())
        assert 3.0 < s <= 5.0, s
        res.append((h._hist.copy(), s))
    np.testing.assert_array_equal(res[0][0], res[1][0])
    assert res[0][1] == res[1][1]


# ---- TestQATCapture -------------------------------------------------------------
def _qat_model(seed=5):
    tp.seed(seed)
    model = nn.Sequential(nn.Linear(8, 8), nn.ReLU(), nn.Linear(8, 2))
    cfg = Q.QuantConfig(activation=Q.FakeQuanterWithAbsMaxObserver(),
                        weight=Q.FakeQuanterChannelWiseAbsMax())
    return Q.QAT(cfg).quantize(model)


def _step(qmodel):
    opt = tp.optimizer.SGD(learning_rate=1e-2,
                           parameters=qmodel.parameters())

    def step(x, y):
        loss = ((qmodel(x) - y) ** 2).mean()
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss
    return step


def _quanters(model):
    return [l for l in model.sublayers()
            if type(l).__name__ == "FakeQuanterWithAbsMaxObserverLayer"]


def test_qat_step_captures_to_static():
    qmodel = _qat_model()
    sstep = tp.jit.to_static(_step(qmodel))
    x = tp.to_tensor(rng.rand(8, 8).astype(np.float32))
    y = tp.to_tensor(rng.rand(8, 2).astype(np.float32))
    l0 = float(sstep(x, y))
    quanters = _quanters(qmodel)
    assert quanters
    s_before = [float(q.scales()) for q in quanters]
    for _ in range(3):
        l1 = float(sstep(x, y))
    s_after = [float(q.scales()) for q in quanters]
    assert l1 < l0
    assert any(a != b for a, b in zip(s_before, s_after))
    assert all(not g.eager_only for g in sstep._cache.values())


def test_captured_qat_step_is_bitwise_its_eager_twin():
    """Two QAT models from one seed: the ``to_static`` step (spy, capture,
    then the captured body) and the eager step give the same losses, and
    every parameter and every EMA ``scale`` / ``state`` buffer is bitwise
    equal after six steps."""
    A, B = _qat_model(9), _qat_model(9)
    static, eager = tp.jit.to_static(_step(A)), _step(B)
    r = np.random.RandomState(3)
    xs = [tp.to_tensor(r.rand(8, 8).astype(np.float32)) for _ in range(6)]
    y = tp.to_tensor(r.rand(8, 2).astype(np.float32))
    got = [static(x, y).numpy() for x in xs]
    want = [eager(x, y).numpy() for x in xs]
    np.testing.assert_array_equal(got, want)
    for (n, p), q in zip(A.named_parameters(), B.parameters()):
        assert torch.equal(p._data, q._data), n
    qa, qb = _quanters(A), _quanters(B)
    assert len(qa) == 2
    for a, b in zip(qa, qb):
        assert torch.equal(a.scale._data, b.scale._data)
        assert torch.equal(a.state._data, b.state._data)
    assert float(qa[0].state) > 1.0     # six EMA updates went in
