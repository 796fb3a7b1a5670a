"""The port's ``nn`` (``paddle_tpu_torch/nn``: ``Layer``, the containers,
the core layers, the functionals of ``activation`` / ``common`` / ``norm``
/ ``loss``, the initializers and gradient clipping) against the JAX
package's, on the CPU.

- ``tests/test_nn.py``'s cases for the modules this slice ports, run on
  the port (``TestLayerBase``, ``TestLayers``, ``TestFunctional``).
- Each functional's value and gradient against the JAX one on the same
  seeded numpy inputs, float32 (``FUNCTIONALS``): values at rtol 1e-5 /
  atol 1e-6 and gradients at rtol 1e-5 / atol 1e-4 (``tests/test_nn.py``
  and ``tests/test_optimizer.py``'s bars), a few sums over many terms at
  the bars their cases state.
- The initializers: ``Constant`` and ``Assign`` exactly, the random ones
  by shape, dtype and moments (their draws are torch's, not threefry's).
- The copied modules' ASTs against the reference's, apart from the
  divergences ``DIVERGENT`` lists (ROADMAP queue 3)."""
import math

import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as JF
import paddle_tpu_torch as tp
import paddle_tpu_torch.nn as nn
import paddle_tpu_torch.nn.functional as F
from _torch_copies import differing_units, statement
from paddle_tpu_torch.core import device as tdevice

rng = np.random.RandomState(0)


@pytest.fixture(autouse=True, scope="module")
def on_cpu():
    prev = tdevice._current_device
    tp.set_device("cpu")
    yield
    tdevice._current_device = prev


def _t(a, grad=False):
    return tp.to_tensor(a, stop_gradient=not grad)


# ------------------------------------------------ tests/test_nn.py, ported
class TestLayerBase:
    def test_registration_and_traversal(self):
        class M(nn.Layer):
            def __init__(self):
                super().__init__()
                self.fc = nn.Linear(2, 3)
                self.sub = nn.Sequential(nn.Linear(3, 3), nn.ReLU())
                self.register_buffer("buf", tp.ones([3]))

            def forward(self, x):
                return self.sub(self.fc(x)) + self.buf

        m = M()
        names = [n for n, _ in m.named_parameters()]
        assert "fc.weight" in names and "sub.0.bias" in names
        assert len(m.parameters()) == 4
        assert len(list(m.named_buffers())) == 1
        assert any(isinstance(lay, nn.ReLU) for lay in m.sublayers())
        out = m(tp.ones([1, 2]))
        assert out.shape == [1, 3]
        assert list(m.state_dict()) == ["fc.weight", "fc.bias", "sub.0.weight",
                                        "sub.0.bias", "buf"]
        m.register_buffer("tmp", tp.zeros([2]), persistable=False)
        assert "tmp" not in m.state_dict()
        del m.tmp
        assert "tmp" not in dict(m.named_buffers())

    def test_train_eval_propagates(self):
        m = nn.Sequential(nn.Linear(2, 2), nn.Dropout(0.5))
        m.eval()
        assert not m[1].training
        m.train()
        assert m[1].training

    def test_state_dict_roundtrip(self):
        m1 = nn.Linear(3, 4)
        m2 = nn.Linear(3, 4)
        m2.set_state_dict(m1.state_dict())
        x = _t(rng.rand(2, 3).astype(np.float32))
        np.testing.assert_allclose(m1(x).numpy(), m2(x).numpy())

    def test_state_dict_numpy_in_and_out_and_missing_keys(self):
        m1, m2 = nn.Linear(3, 4), nn.Linear(3, 4)
        w = m2.weight
        missing, unexpected = m2.set_state_dict(
            {"weight": np.asarray(m1.state_dict()["weight"]), "extra": 1.0})
        assert missing == ["bias"] and unexpected == ["extra"]
        assert m2.weight is w and w.is_leaf and not w.stop_gradient
        np.testing.assert_array_equal(w.numpy(), m1.weight.numpy())

    def test_state_dict_shape_mismatch_raises(self):
        m1, m2 = nn.Linear(3, 4), nn.Linear(3, 5)
        with pytest.raises(ValueError):
            m2.set_state_dict(m1.state_dict())

    def test_forward_hooks(self):
        m = nn.Linear(2, 2)
        calls = []
        h1 = m.register_forward_pre_hook(lambda layer, inp: calls.append("pre"))
        h2 = m.register_forward_post_hook(lambda layer, inp, out: calls.append("post"))
        m(tp.ones([1, 2]))
        assert calls == ["pre", "post"]
        h1.remove()
        h2.remove()
        m(tp.ones([1, 2]))
        assert calls == ["pre", "post"]

    def test_hooks_replace_inputs_and_outputs(self):
        m = nn.Linear(2, 2, bias_attr=False)
        m.register_forward_pre_hook(lambda layer, inp: (inp[0] * 2,))
        m.register_forward_post_hook(lambda layer, inp, out: out + 1)
        x = np.ones((1, 2), np.float32)
        want = 2 * x @ m.weight.numpy() + 1
        np.testing.assert_allclose(m(_t(x)).numpy(), want, rtol=1e-6)

    def test_to_dtype(self):
        m = nn.Linear(2, 2)
        m.to(dtype="bfloat16")
        assert m.weight.dtype == tp.bfloat16

    def test_to_dtype_keeps_parameters_and_the_optimizer_working(self):
        """``to(dtype=)`` keeps every Parameter the same object and a
        trainable leaf: an optimizer built before the cast updates it, and
        its gradient lands after the cast."""
        m = nn.Linear(4, 3)
        opt = tp.optimizer.AdamW(0.1, parameters=m.parameters())
        before = list(m.parameters())
        m.bfloat16()
        assert [id(p) for p in m.parameters()] == [id(p) for p in before]
        assert all(p.is_leaf and not p.stop_gradient for p in before)
        w0 = m.weight.numpy().copy()
        m(_t(np.ones((2, 4), np.float32)).astype("bfloat16")).sum().backward()
        assert m.weight.grad.dtype == tp.bfloat16
        opt.step()
        assert not np.array_equal(m.weight.numpy(), w0)
        m.float()
        assert m.weight.dtype == tp.float32 and m.weight is before[0]

    def test_apply(self):
        m = nn.Sequential(nn.Linear(2, 2), nn.Linear(2, 2))
        seen = []
        m.apply(lambda lay: seen.append(type(lay).__name__))
        assert seen.count("Linear") == 2

    def test_clear_gradients_and_create_parameter(self):
        m = nn.Linear(2, 2)
        m(tp.ones([1, 2])).sum().backward()
        assert m.weight.grad is not None
        m.clear_gradients()
        assert m.weight.grad is None
        attr = tp.ParamAttr(name="w", learning_rate=0.5, trainable=False,
                            initializer=nn.initializer.Constant(3.0))
        p = m.create_parameter([2, 3], attr=attr)
        assert p.name == "w" and p.stop_gradient
        assert p.optimize_attr["learning_rate"] == 0.5
        np.testing.assert_array_equal(p.numpy(), np.full((2, 3), 3.0))
        assert m.create_parameter([2], attr=False) is None


class TestLayers:
    def test_linear_numerics(self):
        m = nn.Linear(3, 4)
        x = rng.rand(5, 3).astype(np.float32)
        ref = x @ m.weight.numpy() + m.bias.numpy()
        np.testing.assert_allclose(m(_t(x)).numpy(), ref, rtol=1e-5)

    def test_embedding(self):
        emb = nn.Embedding(10, 4, padding_idx=0)
        idx = _t(np.array([[1, 0, 3]], np.int64))
        out = emb(idx)
        assert out.shape == [1, 3, 4]
        np.testing.assert_allclose(out.numpy()[0, 1], np.zeros(4))
        out.sum().backward()
        assert emb.weight.grad is not None

    def test_layernorm_grad(self):
        ln = nn.LayerNorm(8)
        x = _t(rng.randn(4, 8).astype(np.float32), grad=True)
        ln(x).sum().backward()
        assert x.grad is not None and ln.weight.grad is not None

    def test_rmsnorm_matches_ref(self):
        m = nn.RMSNorm(8, epsilon=1e-6)
        x = rng.rand(2, 8).astype(np.float32)
        ref = x / np.sqrt((x ** 2).mean(-1, keepdims=True) + 1e-6)
        np.testing.assert_allclose(m(_t(x)).numpy(), ref, atol=1e-5)

    def test_batchnorm_train_eval(self):
        bn = nn.BatchNorm1D(4)
        x = _t(rng.rand(16, 4).astype(np.float32) * 3 + 1)
        bn.train()
        y = bn(x).numpy()
        assert abs(y.mean()) < 1e-4 and abs(y.std() - 1) < 0.1
        # running stats moved toward batch stats
        assert not np.allclose(bn._mean.numpy(), 0)
        bn.eval()
        y2 = bn(x)
        assert y2.shape == [16, 4]

    def test_groupnorm(self):
        gn = nn.GroupNorm(2, 4)
        x = _t(rng.randn(2, 4, 5, 5).astype(np.float32))
        assert gn(x).shape == [2, 4, 5, 5]

    def test_activations(self):
        x = _t(np.array([-2.0, 0.0, 2.0], np.float32))
        np.testing.assert_allclose(nn.ReLU()(x).numpy(), [0, 0, 2])
        assert nn.GELU()(x).shape == [3]
        np.testing.assert_allclose(nn.LeakyReLU(0.1)(x).numpy(), [-0.2, 0, 2], rtol=1e-5)
        np.testing.assert_allclose(nn.Softmax()(x).numpy().sum(), 1.0, rtol=1e-5)

    def test_sequential_and_layerlist(self):
        s = nn.Sequential(nn.Linear(2, 3), nn.ReLU(), nn.Linear(3, 1))
        assert len(s) == 3
        assert s(tp.ones([1, 2])).shape == [1, 1]
        ll = nn.LayerList([nn.Linear(2, 2) for _ in range(3)])
        ll.append(nn.Linear(2, 2))
        assert len(ll) == 4 and len(ll.parameters()) == 8

    def test_containers(self):
        s = nn.Sequential(("a", nn.Linear(2, 2)), ("b", nn.ReLU()))
        assert isinstance(s["b"], nn.ReLU) and len(s[:1]) == 1
        ll = nn.LayerList([nn.ReLU()])
        ll.insert(0, nn.Linear(1, 1))
        ll.extend([nn.Tanh()])
        assert [type(x).__name__ for x in ll] == ["Linear", "ReLU", "Tanh"]
        pl = nn.ParameterList([tp.Parameter(np.ones(2, np.float32))])
        pl.append(tp.Parameter(np.zeros(3, np.float32)))
        assert len(pl) == 2 and len(pl.parameters()) == 2
        d = nn.LayerDict({"x": nn.Linear(2, 2)})
        d["y"] = nn.ReLU()
        assert "y" in d and list(d.keys()) == ["x", "y"] and len(d) == 2
        assert isinstance(d.pop("y"), nn.ReLU) and len(d.parameters()) == 2

    def test_upsample(self):
        x = _t(rng.rand(1, 1, 4, 4).astype(np.float32))
        up = nn.Upsample(scale_factor=2, mode="nearest")
        assert up(x).shape == [1, 1, 8, 8]
        upb = nn.Upsample(scale_factor=2, mode="bilinear")
        assert upb(x).shape == [1, 1, 8, 8]

    def test_pad_layers(self):
        x = tp.ones([1, 1, 2, 2])
        assert nn.Pad2D([1, 1, 1, 1])(x).shape == [1, 1, 4, 4]

    def test_unported_layers_refuse(self):
        with pytest.raises(NotImplementedError, match="M12"):
            nn.SyncBatchNorm(4)
        with pytest.raises(NotImplementedError, match="M12"):
            nn.SyncBatchNorm.convert_sync_batchnorm(nn.BatchNorm1D(4))
        w = nn.Embedding(10, 4, sparse=True)
        with pytest.raises(NotImplementedError, match="SelectedRows"):
            w(_t(np.array([1, 2])))
        with tp.no_grad():      # no gradient to form: the dense lookup
            assert w(_t(np.array([1, 2]))).shape == [2, 4]


class TestFunctional:
    def test_cross_entropy_matches_ref(self):
        logits = rng.rand(8, 5).astype(np.float32)
        labels = rng.randint(0, 5, (8,)).astype(np.int64)
        out = F.cross_entropy(_t(logits), _t(labels)).item()
        e = np.exp(logits - logits.max(1, keepdims=True))
        p = e / e.sum(1, keepdims=True)
        ref = -np.log(p[np.arange(8), labels]).mean()
        assert abs(out - ref) < 1e-5

    def test_cross_entropy_ignore_index(self):
        logits = rng.rand(4, 3).astype(np.float32)
        labels = np.array([0, -100, 2, -100], np.int64)
        out = F.cross_entropy(_t(logits), _t(labels)).item()
        e = np.exp(logits - logits.max(1, keepdims=True))
        p = e / e.sum(1, keepdims=True)
        ref = -np.log(p[[0, 2], [0, 2]]).mean()
        assert abs(out - ref) < 1e-5

    def test_cross_entropy_soft_label(self):
        logits = rng.rand(4, 3).astype(np.float32)
        soft = np.full((4, 3), 1 / 3, np.float32)
        out = F.cross_entropy(_t(logits), _t(soft), soft_label=True).item()
        lse = np.log(np.exp(logits - logits.max(1, keepdims=True)).sum(1)) + logits.max(1)
        ref = (lse - logits.mean(1)).mean()
        assert abs(out - ref) < 1e-4

    def test_cross_entropy_torch_path_is_the_same_body(self):
        """The ``torch.nn`` models call it on torch tensors: the same value
        as the Tensor call, gradient through torch's autograd."""
        logits = rng.randn(6, 5).astype(np.float32)
        labels = np.array([0, 4, -100, 2, 1, 3], np.int32)
        want = F.cross_entropy(_t(logits), _t(labels)).item()
        lt = torch.from_numpy(logits).requires_grad_()
        got = F.cross_entropy(lt, torch.from_numpy(labels))
        assert isinstance(got, torch.Tensor)
        assert got.item() == pytest.approx(want, rel=1e-6)
        got.backward()
        assert lt.grad[2].abs().max().item() == 0.0

    def test_mse_l1(self):
        a, b = rng.rand(4).astype(np.float32), rng.rand(4).astype(np.float32)
        assert abs(F.mse_loss(_t(a), _t(b)).item() - ((a - b) ** 2).mean()) < 1e-6
        assert abs(F.l1_loss(_t(a), _t(b)).item() - np.abs(a - b).mean()) < 1e-6

    def test_bce_with_logits(self):
        z = rng.randn(6).astype(np.float32)
        t = (rng.rand(6) > 0.5).astype(np.float32)
        out = F.binary_cross_entropy_with_logits(_t(z), _t(t)).item()
        p = 1 / (1 + np.exp(-z))
        ref = -(t * np.log(p) + (1 - t) * np.log(1 - p)).mean()
        assert abs(out - ref) < 1e-5

    def test_kl_div(self):
        logp = np.log(np.array([[0.3, 0.7]], np.float32))
        t = np.array([[0.5, 0.5]], np.float32)
        out = F.kl_div(_t(logp), _t(t), reduction="sum").item()
        ref = (t * (np.log(t) - logp)).sum()
        assert abs(out - ref) < 1e-5

    def test_dropout_train_scale(self):
        tp.seed(3)
        x = tp.ones([1000])
        y = F.dropout(x, p=0.5, training=True).numpy()
        assert set(np.unique(y)).issubset({0.0, 2.0})
        assert abs(y.mean() - 1.0) < 0.15
        y2 = F.dropout(x, p=0.5, training=False).numpy()
        np.testing.assert_allclose(y2, 1.0)

    def test_dropout_at_p0_returns_the_input(self):
        x = tp.ones([4])
        assert F.dropout(x, p=0.0) is x
        assert F.dropout(x, p=0.5, training=False) is x
        y = F.dropout(x, p=0.25, training=False, mode="downscale_in_infer")
        np.testing.assert_allclose(y.numpy(), 0.75)
        tp.seed(4)
        a = F.dropout(tp.ones([8, 64]), p=0.5, axis=1).numpy()
        assert (a == a[0]).all()                # one mask along axis 0
        assert F.alpha_dropout(x, p=0.0) is x

    def test_sdpa_causal_masks_future(self):
        # value at position 0 must not see position 1
        q = np.zeros((1, 2, 1, 4), np.float32)
        v = np.zeros((1, 2, 1, 4), np.float32)
        v[0, 1] = 100.0
        out = F.scaled_dot_product_attention(_t(q), _t(q), _t(v), is_causal=True).numpy()
        np.testing.assert_allclose(out[0, 0], 0.0)

    def test_sdpa_matches_naive(self):
        q = rng.rand(2, 4, 2, 8).astype(np.float32)
        k = rng.rand(2, 4, 2, 8).astype(np.float32)
        v = rng.rand(2, 4, 2, 8).astype(np.float32)
        out = F.scaled_dot_product_attention(_t(q), _t(k), _t(v)).numpy()
        qh = q.transpose(0, 2, 1, 3)
        kh = k.transpose(0, 2, 1, 3)
        vh = v.transpose(0, 2, 1, 3)
        logits = qh @ kh.transpose(0, 1, 3, 2) / np.sqrt(8)
        w = np.exp(logits - logits.max(-1, keepdims=True))
        w = w / w.sum(-1, keepdims=True)
        ref = (w @ vh).transpose(0, 2, 1, 3)
        np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-5)

    def test_one_hot_and_label_smooth(self):
        oh = F.one_hot(_t(np.array([0, 2], np.int64)), 3).numpy()
        np.testing.assert_array_equal(oh, [[1, 0, 0], [0, 0, 1]])
        ls = F.label_smooth(_t(oh), epsilon=0.1).numpy()
        np.testing.assert_allclose(ls[0], [0.9 + 0.1 / 3, 0.1 / 3, 0.1 / 3], rtol=1e-5)

    def test_swiglu(self):
        x = rng.rand(2, 8).astype(np.float32)
        out = F.swiglu(_t(x)).numpy()
        a, b = x[:, :4], x[:, 4:]
        ref = a / (1 + np.exp(-a)) * b
        np.testing.assert_allclose(out, ref, rtol=1e-5)

    def test_sequence_mask(self):
        m = F.sequence_mask(_t(np.array([1, 3], np.int64)), maxlen=4)
        np.testing.assert_array_equal(m.numpy(), [[1, 0, 0, 0], [1, 1, 1, 0]])

    def test_unfold_fold_roundtrip(self):
        x = rng.rand(1, 2, 6, 6).astype(np.float32)
        u = F.unfold(_t(x), 2, strides=2)
        assert u.shape == [1, 8, 9]
        back = F.fold(u, [6, 6], 2, strides=2)
        np.testing.assert_allclose(back.numpy(), x, rtol=1e-5)


# ------------------------------------- each functional against the JAX one
def _f(*shape, scale=1.0, shift=0.0):
    return lambda r: (r.randn(*shape) * scale + shift).astype(np.float32)


def _u(*shape, lo=0.05, hi=0.95):
    return lambda r: r.uniform(lo, hi, shape).astype(np.float32)


def _i(*shape, n=5, ignore=False):
    def make(r):
        a = r.randint(0, n, shape).astype(np.int32)
        if ignore:
            a.reshape(-1)[::3] = -100
        return a
    return make


def _sign(*shape):
    return lambda r: np.where(r.rand(*shape) > 0.5, 1.0, -1.0).astype(np.float32)


# name -> (functional, {arg: maker}, differentiable args, kwargs); the args
# go positionally in the order given
X = _f(3, 4, 6, scale=2.0)
FUNCTIONALS = {
    **{n: (n, {"x": X}, ("x",), {}) for n in (
        "relu", "relu6", "sigmoid", "tanh", "silu", "mish", "softsign",
        "tanhshrink", "log_sigmoid", "hardswish", "selu", "swiglu")},
    "gelu": ("gelu", {"x": X}, ("x",), {}),
    "gelu_tanh": ("gelu", {"x": X}, ("x",), {"approximate": True}),
    "leaky_relu": ("leaky_relu", {"x": X}, ("x",), {"negative_slope": 0.2}),
    "elu": ("elu", {"x": X}, ("x",), {"alpha": 0.7}),
    "celu": ("celu", {"x": X}, ("x",), {"alpha": 1.5}),
    "hardtanh": ("hardtanh", {"x": X}, ("x",), {"min": -0.5, "max": 1.5}),
    "hardsigmoid": ("hardsigmoid", {"x": X}, ("x",), {}),
    "hardshrink": ("hardshrink", {"x": X}, ("x",), {"threshold": 0.4}),
    "softshrink": ("softshrink", {"x": X}, ("x",), {"threshold": 0.4}),
    "softplus": ("softplus", {"x": X}, ("x",), {"beta": 2, "threshold": 3}),
    "softmax": ("softmax", {"x": X}, ("x",), {"axis": 1}),
    "log_softmax": ("log_softmax", {"x": X}, ("x",), {"axis": -1}),
    "thresholded_relu": ("thresholded_relu", {"x": X}, ("x",),
                         {"threshold": 0.5, "value": 0.1}),
    "maxout": ("maxout", {"x": X}, ("x",), {"groups": 2, "axis": 1}),
    "glu": ("glu", {"x": X}, ("x",), {"axis": -1}),
    "swiglu_xy": ("swiglu", {"x": X, "y": X}, ("x", "y"), {}),
    "rrelu_eval": ("rrelu", {"x": X}, ("x",), {"training": False}),
    "prelu": ("prelu", {"x": _f(2, 3, 4), "w": _u(3)}, ("x", "w"), {}),
    "linear": ("linear", {"x": _f(2, 5, 6), "w": _f(6, 3), "b": _f(3)},
               ("x", "w", "b"), {}),
    "linear_nobias": ("linear", {"x": _f(4, 6), "w": _f(6, 3)}, ("x", "w"), {}),
    "cosine_similarity": ("cosine_similarity", {"a": _f(4, 6), "b": _f(4, 6)},
                          ("a", "b"), {"axis": 1}),
    "bilinear": ("bilinear", {"a": _f(3, 4), "b": _f(3, 5), "w": _f(2, 4, 5),
                              "bias": _f(1, 2)}, ("a", "b", "w", "bias"), {}),
    "label_smooth": ("label_smooth", {"x": _u(3, 5)}, ("x",), {"epsilon": 0.2}),
    "interp_nearest": ("interpolate", {"x": _f(1, 2, 5, 7)}, ("x",),
                       {"size": [9, 4]}),
    "interp_bilinear_up": ("interpolate", {"x": _f(1, 2, 4, 5)}, ("x",),
                           {"scale_factor": 2, "mode": "bilinear"}),
    "interp_bilinear_down": ("interpolate", {"x": _f(1, 2, 8, 9)}, ("x",),
                             {"size": [3, 4], "mode": "bilinear"}),
    "interp_bicubic": ("interpolate", {"x": _f(1, 1, 5, 6)}, ("x",),
                       {"size": [8, 11], "mode": "bicubic"}),
    "interp_align_corners": ("interpolate", {"x": _f(1, 2, 4, 5)}, ("x",),
                             {"size": [7, 9], "mode": "bilinear",
                              "align_corners": True}),
    "interp_nhwc": ("interpolate", {"x": _f(1, 4, 5, 3)}, ("x",),
                    {"scale_factor": 2, "mode": "bilinear",
                     "data_format": "NHWC"}),
    "unfold": ("unfold", {"x": _f(2, 3, 7, 6)}, ("x",),
               {"kernel_sizes": [3, 2], "strides": [2, 1], "paddings": 1,
                "dilations": [1, 2]}),
    "fold": ("fold", {"x": _f(2, 12, 30)}, ("x",),
             {"output_sizes": [6, 7], "kernel_sizes": 2, "strides": 1,
              "paddings": [0, 0], "dilations": 1}),
    "pixel_shuffle": ("pixel_shuffle", {"x": _f(2, 8, 3, 3)}, ("x",),
                      {"upscale_factor": 2}),
    "pixel_unshuffle": ("pixel_unshuffle", {"x": _f(2, 2, 4, 6)}, ("x",),
                        {"downscale_factor": 2}),
    "channel_shuffle": ("channel_shuffle", {"x": _f(2, 6, 3, 2)}, ("x",),
                        {"groups": 3}),
    "pad_constant": ("pad", {"x": _f(2, 3, 4, 5)}, ("x",),
                     {"pad": [1, 2, 0, 1], "value": 0.5}),
    "pad_reflect": ("pad", {"x": _f(2, 3, 4, 5)}, ("x",),
                    {"pad": [1, 2, 2, 1], "mode": "reflect"}),
    "pad_replicate": ("pad", {"x": _f(2, 3, 4, 5)}, ("x",),
                      {"pad": [2, 0, 1, 3], "mode": "replicate"}),
    "pad_circular": ("pad", {"x": _f(2, 3, 4, 5)}, ("x",),
                     {"pad": [1, 1, 2, 0], "mode": "circular"}),
    "pad_every_dim": ("pad", {"x": _f(2, 3)}, ("x",), {"pad": [1, 0, 2, 1]}),
    "embedding": ("embedding", {"ids": _i(2, 5, n=7), "w": _f(7, 4)}, ("w",),
                  {"padding_idx": 2}),
    "layer_norm": ("layer_norm", {"x": _f(3, 4, 8, shift=1.0),
                                  "shape": lambda r: [8],
                                  "w": _f(8, shift=1.0), "b": _f(8)},
                   ("x", "w", "b"), {"epsilon": 1e-5}),
    "layer_norm_2d": ("layer_norm", {"x": _f(3, 4, 8), "shape": lambda r: [4, 8]},
                      ("x",), {}),
    "rms_norm": ("rms_norm", {"x": _f(3, 8), "w": _f(8, shift=1.0)},
                 ("x", "w"), {"epsilon": 1e-6}),
    "group_norm": ("group_norm", {"x": _f(2, 4, 3, 3), "g": lambda r: 2},
                   ("x",), {"epsilon": 1e-5}),
    "instance_norm": ("instance_norm", {"x": _f(2, 3, 4, 5)}, ("x",), {}),
    "local_response_norm": ("local_response_norm", {"x": _f(2, 6, 3, 3),
                                                    "size": lambda r: 3},
                            ("x",), {"alpha": 0.1, "beta": 0.75, "k": 1.0}),
    "normalize": ("normalize", {"x": _f(4, 5)}, ("x",), {"p": 2, "axis": 1}),
    "normalize_p3": ("normalize", {"x": _f(4, 5)}, ("x",), {"p": 3, "axis": 0}),
    "cross_entropy": ("cross_entropy", {"x": _f(6, 5), "y": _i(6)}, ("x",), {}),
    "ce_ignore_weight": ("cross_entropy", {"x": _f(9, 5), "y": _i(9, ignore=True)},
                         ("x",), {"weight": "w5"}),
    "ce_none": ("cross_entropy", {"x": _f(6, 5), "y": _i(6)}, ("x",),
                {"reduction": "none"}),
    "ce_sum_smooth": ("cross_entropy", {"x": _f(6, 5), "y": _i(6, 1)}, ("x",),
                      {"reduction": "sum", "label_smoothing": 0.1}),
    "ce_soft": ("cross_entropy", {"x": _f(6, 5), "y": _u(6, 5)}, ("x",),
                {"soft_label": True, "label_smoothing": 0.1}),
    "ce_axis1": ("cross_entropy", {"x": _f(2, 5, 3), "y": _i(2, 3)}, ("x",),
                 {"axis": 1}),
    "ce_no_softmax": ("cross_entropy", {"x": _u(6, 5), "y": _i(6)}, ("x",),
                      {"use_softmax": False}),
    "softmax_with_ce": ("softmax_with_cross_entropy", {"x": _f(6, 5),
                                                       "y": _i(6, 1)}, ("x",), {}),
    "nll_loss": ("nll_loss", {"x": _f(6, 5), "y": _i(6, ignore=True)}, ("x",), {}),
    "nll_weight": ("nll_loss", {"x": _f(6, 5), "y": _i(6)}, ("x",),
                   {"weight": "w5"}),
    "nll_sum": ("nll_loss", {"x": _f(6, 5), "y": _i(6, ignore=True)}, ("x",),
                {"reduction": "sum"}),
    "mse_loss": ("mse_loss", {"a": _f(4, 3), "b": _f(4, 3)}, ("a", "b"), {}),
    "l1_loss": ("l1_loss", {"a": _f(4, 3), "b": _f(4, 3)}, ("a", "b"),
                {"reduction": "sum"}),
    "smooth_l1": ("smooth_l1_loss", {"a": _f(4, 3), "b": _f(4, 3)}, ("a", "b"),
                  {"delta": 0.7}),
    "bce": ("binary_cross_entropy", {"p": _u(4, 3), "t": _u(4, 3, lo=0, hi=1),
                                     "w": _u(4, 3)}, ("p", "t", "w"), {}),
    "bce_logits": ("binary_cross_entropy_with_logits",
                   {"z": _f(4, 3), "t": _u(4, 3, lo=0, hi=1)}, ("z", "t"),
                   {"reduction": "none"}),
    "bce_logits_pos": ("binary_cross_entropy_with_logits",
                       {"z": _f(4, 3), "t": _u(4, 3, lo=0, hi=1), "w": _u(4, 3)},
                       ("z", "t", "w"), {"pos_weight": "pw3"}),
    "kl_div": ("kl_div", {"lp": _f(3, 4, shift=-1.5), "t": _u(3, 4)},
               ("lp", "t"), {"reduction": "batchmean"}),
    "kl_div_log": ("kl_div", {"lp": _f(3, 4, shift=-1.5), "t": _f(3, 4, shift=-1)},
                   ("lp", "t"), {"reduction": "sum", "log_target": True}),
    "margin_ranking": ("margin_ranking_loss", {"a": _f(6), "b": _f(6),
                                               "t": _sign(6)}, ("a", "b"),
                       {"margin": 0.1}),
    "hinge_embedding": ("hinge_embedding_loss", {"a": _f(6), "t": _sign(6)},
                        ("a",), {"margin": 0.5}),
    "cosine_embedding": ("cosine_embedding_loss", {"a": _f(4, 5), "b": _f(4, 5),
                                                   "t": _sign(4)}, ("a", "b"),
                         {"margin": 0.2}),
    "triplet_margin": ("triplet_margin_loss", {"a": _f(4, 5), "p": _f(4, 5),
                                               "n": _f(4, 5)}, ("a", "p", "n"),
                       {"swap": True, "p": 3.0}),
    "square_error_cost": ("square_error_cost", {"a": _f(4, 3), "b": _f(4, 3)},
                          ("a", "b"), {}),
    "sigmoid_focal_loss": ("sigmoid_focal_loss", {"z": _f(4, 3),
                                                  "t": _u(4, 3, lo=0, hi=1)},
                           ("z",), {"reduction": "mean"}),
}
# tensors passed by keyword, made from the same seed
KW_TENSORS = {"w5": lambda r: r.uniform(0.5, 2.0, 5).astype(np.float32),
              "pw3": lambda r: r.uniform(0.5, 2.0, 3).astype(np.float32)}


def _run(pkg, fn, arrays, diff, kw, cot_seed):
    F_ = JF if pkg is pt else F
    args = {}
    for k, a in arrays.items():
        if isinstance(a, np.ndarray):
            args[k] = pkg.to_tensor(a, stop_gradient=k not in diff)
        else:
            args[k] = a
    kwargs = {k: (pkg.to_tensor(KW_TENSORS[v](np.random.RandomState(1)))
                  if isinstance(v, str) and v in KW_TENSORS else v)
              for k, v in kw.items()}
    out = getattr(F_, fn)(*args.values(), **kwargs)
    val = np.asarray(out.numpy())
    cot = np.asarray(np.random.RandomState(cot_seed).randn(*val.shape),
                     np.float32)
    if val.dtype.kind == "f":
        (out * pkg.to_tensor(cot)).sum().backward()
    grads = {k: np.asarray(args[k].grad.numpy()) for k in diff}
    return val, grads


@pytest.mark.parametrize("case", sorted(FUNCTIONALS))
def test_functional_value_and_gradient_match_jax(case):
    fn, makers, diff, kw = FUNCTIONALS[case]
    r = np.random.RandomState(sum(map(ord, case)))
    arrays = {k: m(r) for k, m in makers.items()}
    jv, jg = _run(pt, fn, arrays, diff, kw, 7)
    tv, tg = _run(tp, fn, arrays, diff, kw, 7)
    assert tv.shape == jv.shape
    np.testing.assert_allclose(tv, jv, rtol=1e-5, atol=1e-6, err_msg="value")
    for k in diff:
        np.testing.assert_allclose(tg[k], jg[k], rtol=1e-5, atol=1e-4,
                                   err_msg=f"grad {k}")


@pytest.mark.parametrize("training", [True, False])
def test_batch_norm_and_its_running_stats_match_jax(training):
    r = np.random.RandomState(5)
    x = (r.randn(6, 3, 4) * 2 + 1).astype(np.float32)
    w, b = r.rand(3).astype(np.float32), r.randn(3).astype(np.float32)
    rm, rv = r.randn(3).astype(np.float32), r.rand(3).astype(np.float32) + 0.5
    cot = r.randn(6, 3, 4).astype(np.float32)
    got = {}
    for pkg, F_ in ((pt, JF), (tp, F)):
        xs = pkg.to_tensor(x, stop_gradient=False)
        ws = pkg.to_tensor(w, stop_gradient=False)
        mean, var = pkg.to_tensor(rm), pkg.to_tensor(rv)
        out = F_.batch_norm(xs, mean, var, ws, pkg.to_tensor(b),
                            training=training, momentum=0.8)
        (out * pkg.to_tensor(cot)).sum().backward()
        got[pkg] = [np.asarray(t.numpy()) for t in (out, xs.grad, ws.grad,
                                                    mean, var)]
    for name, a, e in zip(("out", "dx", "dw", "running mean", "running var"),
                          got[tp], got[pt]):
        np.testing.assert_allclose(a, e, rtol=1e-5, atol=1e-4, err_msg=name)


@pytest.mark.parametrize("layer,args,x", [
    ("LayerNorm", (6,), (2, 3, 6)), ("RMSNorm", (6,), (2, 6)),
    ("BatchNorm2D", (3,), (4, 3, 2, 2)), ("GroupNorm", (2, 4), (2, 4, 3)),
    ("InstanceNorm2D", (3,), (2, 3, 4, 4)), ("LocalResponseNorm", (3,), (2, 5, 2, 2)),
    ("PReLU", (3, 0.1), (2, 3, 4)), ("Bilinear", (3, 4, 2), None),
    ("Flatten", (), (2, 3, 4)), ("PixelShuffle", (2,), (1, 8, 2, 2)),
    ("Unfold", (2,), (1, 2, 4, 4)), ("CosineSimilarity", (), None),
    ("CrossEntropyLoss", (), None), ("MSELoss", (), None),
    ("SmoothL1Loss", (), None), ("KLDivLoss", ("sum",), None),
])
def test_layers_match_jax_with_the_same_weights(layer, args, x):
    """Each layer built on both sides, the JAX layer's ``state_dict`` loaded
    into the port's, the same inputs: the same output."""
    r = np.random.RandomState(len(layer))
    jl, tl = getattr(jnn, layer)(*args), getattr(nn, layer)(*args)
    state = {k: np.asarray(v.numpy()) for k, v in jl.state_dict().items()}
    assert list(tl.state_dict()) == list(state)
    tl.set_state_dict(state)
    if layer == "Bilinear":
        ins = [r.randn(5, 3), r.randn(5, 4)]
    elif layer == "CosineSimilarity":
        ins = [r.randn(3, 4), r.randn(3, 4)]
    elif layer == "CrossEntropyLoss":
        ins = [r.randn(4, 5), r.randint(0, 5, 4)]
    elif layer in ("MSELoss", "SmoothL1Loss"):
        ins = [r.randn(4, 5), r.randn(4, 5)]
    elif layer == "KLDivLoss":
        ins = [r.randn(4, 5) - 2, r.rand(4, 5)]
    else:
        ins = [r.randn(*x)]
    ins = [a.astype(np.float32) if a.dtype.kind == "f" else a.astype(np.int32)
           for a in ins]
    want = np.asarray(jl(*[pt.to_tensor(a) for a in ins]).numpy())
    got = tl(*[tp.to_tensor(a) for a in ins]).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_activation_layers_cover_the_reference():
    import paddle_tpu.nn.layer.activation as ja
    import paddle_tpu_torch.nn.layer.activation as ta
    names = [n for n in dir(ja) if isinstance(getattr(ja, n), type)
             and issubclass(getattr(ja, n), jnn.Layer) and n != "Layer"]
    assert len(names) > 25
    x = np.random.RandomState(3).randn(2, 4, 6).astype(np.float32)
    for n in names:
        args = {"PReLU": (), "Maxout": (2,), "GLU": ()}.get(n, ())
        jl, tl = getattr(ja, n)(*args), getattr(ta, n)(*args)
        tl.set_state_dict({k: np.asarray(v.numpy())
                           for k, v in jl.state_dict().items()})
        jl.eval()
        tl.eval()
        np.testing.assert_allclose(tl(tp.to_tensor(x)).numpy(),
                                   np.asarray(jl(pt.to_tensor(x)).numpy()),
                                   rtol=1e-5, atol=1e-6, err_msg=n)


# ------------------------------------------------------------ initializers
def test_constant_and_assign_initializers_are_exact():
    init = nn.initializer
    np.testing.assert_array_equal(init.Constant(0.25)([2, 3], "float32").numpy(),
                                  np.full((2, 3), 0.25, np.float32))
    v = np.arange(6, dtype=np.float32)
    out = init.Assign(v)([2, 3], "bfloat16")
    assert out.dtype == torch.bfloat16 and out.device.type == "cpu"
    np.testing.assert_array_equal(out.float().numpy(), v.reshape(2, 3))
    np.testing.assert_array_equal(
        init.Assign(tp.to_tensor(v))([3, 2], "float32").numpy(), v.reshape(3, 2))
    d = init.Dirac()([2, 2, 3], "float32").numpy()
    assert d[0, 0, 1] == d[1, 1, 1] == 1 and d.sum() == 2


@pytest.mark.parametrize("name,kw,shape,mean,std", [
    ("Normal", {"mean": 0.5, "std": 2.0}, (200, 100), 0.5, 2.0),
    ("TruncatedNormal", {"std": 1.0}, (200, 100), 0.0, 0.8796),
    ("Uniform", {"low": -1.0, "high": 3.0}, (200, 100), 1.0, 4 / math.sqrt(12)),
    ("XavierNormal", {}, (300, 100), 0.0, math.sqrt(2 / 400)),
    ("XavierUniform", {}, (300, 100), 0.0, math.sqrt(6 / 400) / math.sqrt(3)),
    ("KaimingNormal", {}, (200, 100), 0.0, math.sqrt(2 / 200)),
    ("KaimingUniform", {}, (200, 100), 0.0, math.sqrt(6 / 200) / math.sqrt(3)),
])
def test_random_initializers_by_shape_dtype_and_moments(name, kw, shape, mean, std):
    tp.seed(11)
    a = getattr(nn.initializer, name)(**kw)(list(shape), "float32")
    assert tuple(a.shape) == shape and a.dtype == torch.float32
    tol = 5 * std / math.sqrt(a.numel())
    assert abs(a.mean().item() - mean) < tol + 1e-6
    assert abs(a.std().item() - std) < 0.03 * std
    if name == "TruncatedNormal":
        assert a.abs().max().item() <= 2.0
    tp.seed(11)
    b = getattr(nn.initializer, name)(**kw)(list(shape), "float32")
    assert torch.equal(a, b)                 # paddle.seed makes it repeat


def test_orthogonal_initializer_is_orthogonal():
    q = nn.initializer.Orthogonal(gain=2.0)([4, 6], "float32")
    np.testing.assert_allclose((q @ q.T).numpy(), 4 * np.eye(4), atol=1e-5)
    assert nn.initializer._resolve(False, None) == (None, None)
    pa, ini = nn.initializer._resolve("name", nn.initializer.Constant())
    assert pa.name == "name" and isinstance(ini, nn.initializer.Constant)
    assert tp.ParamAttr is nn.ParamAttr


# ------------------------------------------------------------ gradient clip
@pytest.mark.parametrize("norm_type", [2.0, float("inf")])
def test_clip_grad_norm_and_value_match_jax(norm_type):
    r = np.random.RandomState(2)
    gs = [r.randn(3, 4).astype(np.float32) * 3, r.randn(5).astype(np.float32)]
    out = {}
    for pkg, nn_ in ((pt, jnn), (tp, nn)):
        ps = [pkg.Parameter(np.zeros_like(g)) for g in gs]
        for p, g in zip(ps, gs):
            p.grad = pkg.to_tensor(g)
        total = nn_.clip_grad_norm_(ps, 1.5, norm_type=norm_type)
        out[pkg] = [float(total.numpy())] + [np.asarray(p.grad.numpy()) for p in ps]
        nn_.clip_grad_value_(ps, 0.1)
        out[pkg] += [np.asarray(p.grad.numpy()) for p in ps]
    for a, e in zip(out[tp], out[pt]):
        np.testing.assert_allclose(a, e, rtol=1e-5, atol=1e-7)


# ------------------------------------------------------------ copy fidelity
# port path -> the units that differ on purpose (ROADMAP queue 3), keyed as
# ``_torch_copies.units`` keys them
DIVERGENT = {
    "nn/layer/container.py": set(),
    "nn/layer/activation.py": set(),
    "nn/layer/loss.py": set(),
    # torch in jax's place: host data and checkpoints become torch tensors,
    # set_state_dict copies in place, to() rebinds each floating buffer
    "nn/layer/layers.py": {
        "__doc__", statement("import jax.numpy as jnp"),
        statement("import torch"),
        statement("from ...core.tensor import Tensor, Parameter"),
        statement("from ...core.tensor import Tensor, Parameter, _host_buf"),
        "Layer.add_parameter", "Layer.register_buffer",
        "Layer.set_state_dict", "Layer.to"},
    # the padding row zeroed in place
    "nn/layer/common.py": {statement("import torch"), "Embedding.__init__"},
    # buffers from numpy; SyncBatchNorm (M12) refuses; SpectralNorm draws
    # u / v on the port's generator and iterates in torch
    "nn/layer/norm.py": {
        statement("import jax.numpy as jnp"), "_BatchNormBase.__init__",
        "SyncBatchNorm", "SyncBatchNorm.__init__",
        "SyncBatchNorm.convert_sync_batchnorm",
        "SpectralNorm.__init__", "SpectralNorm.forward"},
    # a scheduler fills the bound optimizers' learning-rate tensor in place
    "optimizer/lr.py": {"__doc__", "LRScheduler.step", "ReduceOnPlateau.step"},
    # the Layer GPT-2: the loss body is torch's; recompute refuses until
    # fleet.recompute (M12)
    "models/gpt2.py": {
        "__doc__", statement("import torch"),
        statement("import torch.nn.functional as TF"),
        statement("from torch.utils.checkpoint import checkpoint"),
        "GPT2Model.forward", "_chunk_loss", "_chunked_lm_loss_body",
        "_chunked_lm_loss"},
}


@pytest.mark.parametrize("path", sorted(DIVERGENT))
def test_copy_matches_the_reference(path):
    assert differing_units(path) == DIVERGENT[path]
