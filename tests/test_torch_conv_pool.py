"""The port's convolution, pooling and rope functionals and layers, and the
modules this slice lifted out of refusal (``SpectralNorm``,
``PairwiseDistance``, ``nn.utils``), against the JAX package's on the CPU.

- Each functional's value and the gradients of a weighted sum of it (input,
  weight, bias) against the JAX one on the same seeded numpy inputs,
  float32: values at rtol 1e-5 / atol 1e-5 and gradients at rtol 1e-4 /
  atol 1e-4 (``tests/test_nn.py``'s conv bar, a sum over a window of
  products), over Paddle's padding forms ("SAME", "VALID", one int, one a
  dim, (lo, hi) pairs, the flat list), strides, dilation, groups,
  channel-last formats and, for the transposed convolutions,
  ``output_padding``; the pools over ``ceil_mode``, ``exclusive``,
  ``return_mask`` with ``max_unpool``, and uneven adaptive bins.
- The layers built from the JAX layers' weights (``set_state_dict``).
- ``tests/test_nn.py``'s conv / pool / rope / pad cases, run on the port.
- ``SpectralNorm`` given the JAX layer's ``u`` / ``v``: output, gradient and
  the updated ``u`` / ``v``; ``PairwiseDistance``; ``nn.utils``.
- The copies ``nn/layer/{conv,pooling,transformer}.py`` and
  ``models/ernie.py``: their ASTs are the reference's but the units
  ``DIVERGENT`` lists.
"""
import numpy as np
import pytest

import paddle_tpu as pt
import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as JF
import paddle_tpu_torch as tp
import paddle_tpu_torch.nn as nn
import paddle_tpu_torch.nn.functional as F
from _torch_copies import differing_units, statement
from paddle_tpu_torch.core import device as tdevice

rng = np.random.RandomState(0)
VAL = dict(rtol=1e-5, atol=1e-5)
GRAD = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(autouse=True, scope="module")
def on_cpu():
    prev = tdevice._current_device
    tp.set_device("cpu")
    yield
    tdevice._current_device = prev


def _both(fn_name, arrays, grad=True, **kw):
    """fn over the same inputs on both packages: (port out, JAX out, port
    grads, JAX grads) as numpy; the gradients of sum(out * w) for a fixed
    random w, of every float input."""
    res = []
    for pkg, mod in ((tp, F), (pt, JF)):
        ins = []
        for a in arrays:
            t = pkg.to_tensor(a)
            if grad and a.dtype == np.float32:
                t.stop_gradient = False
            ins.append(t)
        out = getattr(mod, fn_name)(*ins, **kw)
        first = out[0] if isinstance(out, tuple) else out
        grads = []
        if grad:
            w = np.random.RandomState(9).uniform(
                0.5, 1.5, first.shape).astype(np.float32)
            (first * pkg.to_tensor(w)).sum().backward()
            grads = [np.asarray(t.grad.numpy()) for t in ins
                     if not t.stop_gradient]
        outs = out if isinstance(out, tuple) else (out,)
        res.append(([np.asarray(o.numpy()) for o in outs], grads))
    (tout, tg), (jout, jg) = res
    return tout, jout, tg, jg


def _check(fn_name, arrays, grad=True, **kw):
    tout, jout, tg, jg = _both(fn_name, arrays, grad, **kw)
    for i, (t, j) in enumerate(zip(tout, jout)):
        assert t.shape == j.shape, (fn_name, kw, i, t.shape, j.shape)
        if np.issubdtype(j.dtype, np.integer):
            np.testing.assert_array_equal(t, j, err_msg=f"{fn_name} {kw}")
        else:
            np.testing.assert_allclose(t, j, **VAL,
                                       err_msg=f"{fn_name} {kw} out {i}")
    assert len(tg) == len(jg)
    for i, (t, j) in enumerate(zip(tg, jg)):
        np.testing.assert_allclose(t, j, **GRAD,
                                   err_msg=f"{fn_name} {kw} grad {i}")


def _u(*shape, seed=0):
    return np.random.RandomState(seed).uniform(-1, 1, shape).astype(
        np.float32)


# (functional, x shape, weight shape, kwargs)
CONV = [
    ("conv1d", (2, 3, 11), (4, 3, 3), {}),
    ("conv1d", (2, 3, 11), (4, 3, 3), {"padding": "SAME", "stride": 2}),
    ("conv1d", (2, 11, 4), (6, 2, 3), {"groups": 2, "data_format": "NLC",
                                       "padding": [1, 2]}),
    ("conv2d", (2, 3, 9, 8), (4, 3, 3, 3), {"padding": 1}),
    ("conv2d", (2, 3, 9, 8), (4, 3, 3, 3), {"padding": "SAME", "stride": 2}),
    ("conv2d", (2, 3, 9, 8), (4, 3, 3, 2), {"padding": "VALID",
                                            "dilation": 2}),
    ("conv2d", (2, 3, 9, 8), (4, 3, 3, 3), {"padding": [1, 0, 2, 1]}),
    ("conv2d", (2, 3, 9, 8), (4, 3, 3, 3), {"padding": [(0, 1), (2, 0)],
                                            "stride": [2, 1]}),
    ("conv2d", (2, 4, 16, 16), (8, 2, 3, 3), {"stride": 2, "padding": 1,
                                              "dilation": 2, "groups": 2}),
    ("conv2d", (2, 9, 8, 3), (4, 3, 3, 3), {"padding": 1, "stride": 2,
                                            "data_format": "NHWC"}),
    ("conv3d", (1, 2, 5, 6, 7), (3, 2, 3, 2, 3), {"padding": [1, 0, 1]}),
    ("conv3d", (1, 5, 6, 7, 2), (3, 2, 3, 3, 3), {"padding": "SAME",
                                                  "data_format": "NDHWC"}),
]


@pytest.mark.parametrize("fn,xs,ws,kw", CONV,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(CONV)])
@pytest.mark.parametrize("bias", [False, True])
def test_conv_matches_jax(fn, xs, ws, kw, bias):
    arrays = [_u(*xs), _u(*ws, seed=1)]
    if bias:
        arrays.append(_u(ws[0], seed=2))
    _check(fn, arrays, **kw)


# (functional, x shape, weight shape [in, out / groups, *k], kwargs)
CONV_T = [
    ("conv1d_transpose", (2, 3, 7), (3, 4, 3), {"stride": 2}),
    ("conv1d_transpose", (2, 3, 7), (3, 4, 4), {"stride": 2, "padding": 1,
                                                "output_padding": 1}),
    ("conv2d_transpose", (1, 4, 8, 8), (4, 3, 4, 4), {"stride": 2,
                                                      "padding": 1}),
    ("conv2d_transpose", (1, 4, 5, 6), (4, 3, 3, 3), {"stride": 2,
                                                      "output_padding": 1}),
    ("conv2d_transpose", (1, 4, 5, 6), (4, 2, 3, 3), {"groups": 2,
                                                      "dilation": 2,
                                                      "padding": [1, 2]}),
    ("conv2d_transpose", (1, 4, 5, 6), (4, 3, 3, 2), {"padding": "SAME",
                                                      "dilation": 2}),
    ("conv2d_transpose", (1, 4, 5, 6), (4, 3, 3, 3), {"padding": "VALID"}),
    ("conv2d_transpose", (1, 5, 6, 4), (4, 3, 3, 3), {
        "stride": 2, "padding": 1, "data_format": "NHWC"}),
    ("conv3d_transpose", (1, 2, 3, 4, 3), (2, 3, 3, 3, 2), {"stride": 2,
                                                            "padding": 1}),
]


@pytest.mark.parametrize("fn,xs,ws,kw", CONV_T,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(CONV_T)])
def test_conv_transpose_matches_jax(fn, xs, ws, kw):
    groups = kw.get("groups", 1)
    _check(fn, [_u(*xs), _u(*ws, seed=1), _u(ws[1] * groups, seed=2)], **kw)


def test_strided_transposed_conv_refuses_string_padding_as_jax_does():
    for pkg, mod in ((tp, F), (pt, JF)):
        with pytest.raises(ValueError, match="String padding"):
            mod.conv2d_transpose(pkg.to_tensor(_u(1, 4, 5, 6)),
                                 pkg.to_tensor(_u(4, 3, 3, 3)), stride=2,
                                 padding="SAME")


# (functional, x shape, kwargs)
POOL = [
    ("max_pool1d", (2, 3, 11), {"kernel_size": 3, "stride": 2,
                                "padding": 1}),
    ("max_pool1d", (2, 3, 11), {"kernel_size": 3, "ceil_mode": True}),
    ("avg_pool1d", (2, 3, 11), {"kernel_size": 3, "stride": 2, "padding": 1,
                                "exclusive": False}),
    ("max_pool2d", (2, 3, 9, 8), {"kernel_size": 2}),
    ("max_pool2d", (2, 3, 9, 8), {"kernel_size": 3, "stride": 2,
                                  "padding": 1}),
    ("max_pool2d", (2, 3, 9, 8), {"kernel_size": 3, "stride": 2,
                                  "ceil_mode": True}),
    ("max_pool2d", (2, 3, 9, 8), {"kernel_size": [3, 2], "stride": 2,
                                  "padding": "SAME"}),
    ("max_pool2d", (2, 9, 8, 3), {"kernel_size": 3, "stride": 2,
                                  "padding": 1, "data_format": "NHWC"}),
    ("avg_pool2d", (2, 3, 9, 8), {"kernel_size": 3, "stride": 2,
                                  "padding": 1}),
    ("avg_pool2d", (2, 3, 9, 8), {"kernel_size": 3, "stride": 2,
                                  "padding": 1, "exclusive": False}),
    ("avg_pool2d", (2, 3, 9, 8), {"kernel_size": 3, "stride": 2,
                                  "ceil_mode": True}),
    ("avg_pool2d", (2, 3, 9, 8), {"kernel_size": 2, "padding": [1, 0, 0, 1]}),
    ("max_pool3d", (1, 2, 5, 6, 7), {"kernel_size": 2, "stride": 2,
                                     "ceil_mode": True}),
    ("avg_pool3d", (1, 2, 5, 6, 7), {"kernel_size": 3, "stride": 2,
                                     "padding": 1}),
    ("adaptive_avg_pool1d", (2, 3, 11), {"output_size": 4}),
    ("adaptive_max_pool1d", (2, 3, 11), {"output_size": 4}),
    ("adaptive_avg_pool2d", (2, 3, 9, 7), {"output_size": [4, 3]}),
    ("adaptive_avg_pool2d", (2, 3, 9, 7), {"output_size": 1}),
    ("adaptive_avg_pool2d", (2, 9, 7, 3), {"output_size": 4,
                                           "data_format": "NHWC"}),
    ("adaptive_max_pool2d", (2, 3, 9, 7), {"output_size": [5, 2]}),
    ("adaptive_avg_pool3d", (1, 2, 5, 6, 7), {"output_size": [2, 3, 4]}),
    ("adaptive_max_pool3d", (1, 2, 5, 6, 7), {"output_size": 3}),
]


@pytest.mark.parametrize("fn,xs,kw", POOL,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(POOL)])
def test_pool_matches_jax(fn, xs, kw):
    _check(fn, [_u(*xs)], **kw)


@pytest.mark.parametrize("n,kw", [
    (1, {"kernel_size": 2}), (1, {"kernel_size": 3, "stride": 2,
                                  "padding": 1}),
    (2, {"kernel_size": 2}), (2, {"kernel_size": 3, "stride": 2,
                                  "padding": 1}),
    (2, {"kernel_size": 3, "stride": 2, "ceil_mode": True})])
def test_max_pool_mask_and_unpool_match_jax(n, kw):
    xs = (2, 3, 12) if n == 1 else (2, 3, 8, 9)
    x = _u(*xs)
    _check(f"max_pool{n}d", [x], return_mask=True, **kw)
    ukw = {k: v for k, v in kw.items() if k != "ceil_mode"}
    if kw.get("ceil_mode"):
        ukw["output_size"] = list(xs[2:])
    outs = []
    for pkg, mod in ((tp, F), (pt, JF)):
        out, mask = getattr(mod, f"max_pool{n}d")(pkg.to_tensor(x),
                                                  return_mask=True, **kw)
        outs.append(np.asarray(getattr(mod, f"max_unpool{n}d")(
            out, mask, **ukw).numpy()))
    np.testing.assert_array_equal(outs[0], outs[1])


ROPE = [
    {}, {"use_neox_rotary_style": False},
    {"position_ids": np.array([[3, 4, 5, 6, 7, 8], [0, 2, 4, 6, 8, 10]],
                              np.int32)},
    {"position_ids": np.array([[9, 10, 11, 12, 13, 14]] * 2, np.int32),
     "max_position": 32, "use_neox_rotary_style": False},
    {"rotary_emb_base": 500.0},
]


@pytest.mark.parametrize("kw", ROPE, ids=[str(i) for i in range(len(ROPE))])
def test_rope_matches_jax(kw):
    q, k, v = _u(2, 6, 3, 8), _u(2, 6, 1, 8, seed=1), _u(2, 6, 1, 8, seed=2)
    outs = []
    for pkg, mod in ((tp, F), (pt, JF)):
        ins = [pkg.to_tensor(a) for a in (q, k, v)]
        for t in ins:
            t.stop_gradient = False
        kk = {n: pkg.to_tensor(a) if isinstance(a, np.ndarray) else a
              for n, a in kw.items()}
        oq, ok, ov = mod.fused_rotary_position_embedding(*ins, **kk)
        (oq * oq).sum().backward()
        outs.append([np.asarray(o.numpy()) for o in (oq, ok, ov)]
                    + [np.asarray(ins[0].grad.numpy())])
    for a, b in zip(*outs):
        np.testing.assert_allclose(a, b, **VAL)


def test_rope_with_given_sin_cos_matches_jax():
    from paddle_tpu.nn.functional import rope as jrope
    from paddle_tpu_torch.nn.functional import rope as trope
    q = _u(1, 5, 2, 8)
    s, c = trope.rotary_embedding_sin_cos(5, 8)
    js, jc = jrope.rotary_embedding_sin_cos(5, 8)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), **VAL)
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), **VAL)
    got = trope.fused_rotary_position_embedding(tp.to_tensor(q), sin=s,
                                                cos=c)[0]
    want = jrope.fused_rotary_position_embedding(pt.to_tensor(q), sin=js,
                                                 cos=jc)[0]
    np.testing.assert_allclose(got.numpy(), np.asarray(want.numpy()), **VAL)


@pytest.mark.parametrize("name,args,kw", [
    ("Conv2D", (3, 4, 3), {"stride": 2, "padding": 1}),
    ("Conv1D", (3, 4, 3), {"padding": "SAME"}),
    ("Conv3D", (2, 3, 3), {"padding": 1}),
    ("Conv2DTranspose", (4, 3, 4), {"stride": 2, "padding": 1}),
    ("Conv1DTranspose", (3, 2, 3), {"stride": 2}),
    ("MaxPool2D", (3,), {"stride": 2, "padding": 1}),
    ("AvgPool2D", (2,), {"ceil_mode": True}),
    ("AvgPool1D", (3,), {"stride": 2}),
    ("MaxPool1D", (2,), {}),
    ("AdaptiveAvgPool2D", (3,), {}),
    ("AdaptiveMaxPool1D", (4,), {}),
])
def test_layers_with_the_jax_layers_weights(name, args, kw):
    pt.seed(0)
    jl = getattr(jnn, name)(*args, **kw)
    tl = getattr(nn, name)(*args, **kw)
    state = {k: np.asarray(v.numpy()) for k, v in jl.state_dict().items()}
    assert tl.set_state_dict(state) == ([], [])
    nd = 1 if "1D" in name else 3 if "3D" in name else 2
    ch = args[0] if "Conv" in name else 3
    x = _u(2, ch, *([7, 8, 6][:nd]))
    np.testing.assert_allclose(tl(tp.to_tensor(x)).numpy(),
                               np.asarray(jl(pt.to_tensor(x)).numpy()), **VAL)


# ------------------------------------------ tests/test_nn.py cases, ported
class TestNNCases:
    def test_conv2d_matches_manual(self):
        conv = nn.Conv2D(1, 1, 3, padding=0, bias_attr=False)
        w = conv.weight.numpy()[0, 0]
        img = rng.rand(1, 1, 5, 5).astype(np.float32)
        out = conv(tp.to_tensor(img)).numpy()[0, 0]
        ref = np.zeros((3, 3), np.float32)
        for i in range(3):
            for j in range(3):
                ref[i, j] = (img[0, 0, i:i+3, j:j+3] * w).sum()
        np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-5)

    def test_conv_groups_dilation_stride(self):
        conv = nn.Conv2D(4, 8, 3, stride=2, padding=1, dilation=2, groups=2)
        out = conv(tp.randn([2, 4, 16, 16]))
        assert out.shape[0] == 2 and out.shape[1] == 8

    def test_conv_transpose_shape(self):
        deconv = nn.Conv2DTranspose(4, 3, 4, stride=2, padding=1)
        out = deconv(tp.randn([1, 4, 8, 8]))
        assert out.shape == [1, 3, 16, 16]

    def test_pools(self):
        x = tp.to_tensor(rng.rand(1, 2, 8, 8).astype(np.float32))
        assert nn.MaxPool2D(2)(x).shape == [1, 2, 4, 4]
        assert nn.AvgPool2D(2)(x).shape == [1, 2, 4, 4]
        assert nn.AdaptiveAvgPool2D(1)(x).shape == [1, 2, 1, 1]
        np.testing.assert_allclose(nn.AdaptiveAvgPool2D(1)(x).numpy().reshape(1, 2),
                                   x.numpy().mean((2, 3)), rtol=1e-5)

    def test_pad_then_conv(self):
        x = tp.ones([1, 1, 2, 2])
        padded = nn.Pad2D([1, 1, 1, 1])(x)
        assert padded.shape == [1, 1, 4, 4]
        conv = nn.Conv2D(1, 1, 3, bias_attr=False)
        conv.weight.set_value(np.ones((1, 1, 3, 3), np.float32))
        np.testing.assert_allclose(conv(padded).numpy()[0, 0],
                                   np.full((2, 2), 4.0))

    def test_rope_rotation_property(self):
        # RoPE preserves norms
        q = rng.rand(1, 4, 2, 8).astype(np.float32)
        qr, _, _ = F.fused_rotary_position_embedding(tp.to_tensor(q))
        np.testing.assert_allclose(np.linalg.norm(qr.numpy(), axis=-1),
                                   np.linalg.norm(q, axis=-1), rtol=1e-4)


@pytest.mark.parametrize("shape,dim,iters", [([4, 3], 0, 1),
                                             ([4, 3, 2], 1, 3),
                                             ([5, 6], 1, 2)])
def test_spectral_norm_given_the_same_u_v_matches_jax(shape, dim, iters):
    pt.seed(0)
    j = jnn.SpectralNorm(shape, dim=dim, power_iters=iters)
    t = nn.SpectralNorm(shape, dim=dim, power_iters=iters)
    assert t.weight_u.shape == list(j.weight_u.shape)
    assert t.weight_v.shape == list(j.weight_v.shape)
    np.testing.assert_allclose(np.linalg.norm(t.weight_u.numpy()), 1.0,
                               rtol=1e-6)
    t.set_state_dict({k: np.asarray(v.numpy())
                      for k, v in j.state_dict().items()})
    w = _u(*shape, seed=3)
    outs = []
    for pkg, layer in ((tp, t), (pt, j)):
        x = pkg.to_tensor(w)
        x.stop_gradient = False
        out = layer(x)
        (out * out).sum().backward()
        outs.append([np.asarray(a) for a in (
            out.numpy(), x.grad.numpy(), layer.weight_u.numpy(),
            layer.weight_v.numpy())])
    for a, b in zip(*outs):
        np.testing.assert_allclose(a, b, **VAL)


def test_spectral_norm_draws_on_the_port_generator():
    tp.seed(3)
    a = nn.SpectralNorm([6, 4]).weight_u.numpy()
    tp.seed(3)
    b = nn.SpectralNorm([6, 4]).weight_u.numpy()
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kw", [{}, {"p": 1.0, "keepdim": True},
                                {"p": np.inf}])
def test_pairwise_distance_matches_jax(kw):
    x, y = _u(4, 5), _u(4, 5, seed=1)
    got = nn.PairwiseDistance(**kw)(tp.to_tensor(x), tp.to_tensor(y))
    want = jnn.PairwiseDistance(**kw)(pt.to_tensor(x), pt.to_tensor(y))
    np.testing.assert_allclose(got.numpy(), np.asarray(want.numpy()), **VAL)


def test_parameters_vector_round_trip_matches_jax():
    pt.seed(0)
    jm = jnn.Sequential(jnn.Linear(3, 4), jnn.Linear(4, 2))
    tm = nn.Sequential(nn.Linear(3, 4), nn.Linear(4, 2))
    tm.set_state_dict({k: np.asarray(v.numpy())
                       for k, v in jm.state_dict().items()})
    tv = nn.utils.parameters_to_vector(tm.parameters())
    jv = jnn.utils.parameters_to_vector(jm.parameters())
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv.numpy()))
    assert tv.shape == [3 * 4 + 4 + 4 * 2 + 2] and tv.stop_gradient
    new = np.arange(tv.shape[0], dtype=np.float32)
    nn.utils.vector_to_parameters(tp.to_tensor(new), tm.parameters())
    jnn.utils.vector_to_parameters(pt.to_tensor(new), jm.parameters())
    for a, b in zip(tm.parameters(), jm.parameters()):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b.numpy()))
        assert a.is_leaf and not a.stop_gradient
    # the written parameters still train
    tm(tp.ones([1, 3])).sum().backward()
    assert all(p.grad is not None for p in tm.parameters())


# the units of each copy that differ from the reference's
DIVERGENT = {
    "nn/layer/conv.py": set(),
    "nn/layer/pooling.py": set(),
    # the causal mask: numpy, then a tensor on the current place
    "nn/layer/transformer.py": {statement("import jax.numpy as jnp"),
                                "Transformer.generate_square_subsequent_mask"},
    # decoder_bias: a float32 zero Parameter on the current place
    "models/ernie.py": {"ErnieForMaskedLM.__init__"},
}


@pytest.mark.parametrize("path", sorted(DIVERGENT))
def test_copy_matches_the_reference(path):
    assert differing_units(path) == DIVERGENT[path]
