"""The port's ``vision`` package (``paddle_tpu_torch/vision/``) against the
JAX package's, on the CPU.

- Models: ResNet-18 and MobileNetV3-small (scale 0.5), 10 classes, B 2 at
  64 x 64 (at 32 x 32 both end at 1 x 1, where train-mode BatchNorm
  normalizes two values a channel: it multiplies float32 rounding by
  hundreds, and ResNet-18's logits part at 2e-3 while every stage before
  agrees to 5e-6), from the same weights (the JAX model's ``state_dict()`` as numpy
  into the port's ``set_state_dict``).  One train step (train mode, the
  classifier's dropout off on both sides, cross entropy, backward): the
  logits within 1e-4 of their largest magnitude, every parameter's
  gradient within 1e-4 of its largest magnitude (2e-6 at least: a bias
  under a later BatchNorm has a zero gradient up to rounding), BatchNorm's
  running mean
  and variance within 1e-5.  The JAX side's initializers draw from numpy
  here (``_numpy_init``): its own draw compiles one XLA program a shape,
  which is most of an eager CPU run; the weights still cross from it.
- The parameter count of every factory on the port against the canonical
  (torchvision) numbers, which the reference's tests hold for the JAX zoo;
  the reference's ``test_vision_extra.py`` zoo classes mirrored on the
  port at 64 x 64.
- ``ops``: ``box_area`` / ``box_iou``; ``nms`` on random boxes (scores with
  ties, categories, ``top_k``) equal to the JAX indices; ``roi_align``
  (aligned or not, sampling ratio 2 or 3, rois over two images, rois past
  the border) and ``roi_pool``, forward and gradients (feature and boxes
  for ``roi_align``, feature for ``roi_pool``) within 1e-5 of the largest
  magnitude; the reference's ``TestVisionOps`` mirrored.
- ``transforms``: every transform and functional of the module on the same
  numpy input and ``np.random`` seed, equal to the JAX package's (1e-5
  absolute and 1e-6 relative:
  only ``Resize`` has its own code, ``jax.image.resize``'s antialiased
  triangle weights in torch).
- ``datasets``: the reference's ``TestVisionDatasets`` mirrored, every item
  equal to the JAX dataset's on the same seeded files; ``ImageFolder``.
- The image backend switch and ``image_load``.
- The copies ``vision/{__init__,datasets/__init__,models/*}.py`` ASTs equal
  to the reference's; ``transforms/__init__.py`` but ``Resize.__call__``.
"""
import gzip
import io as _io
import os
import pickle
import struct
import tarfile

import numpy as np
import pytest

import paddle_tpu as pt
import paddle_tpu_torch as tp
from paddle_tpu_torch.core import device as tdevice
from _torch_copies import differing_units

rng = np.random.RandomState(0)


@pytest.fixture(autouse=True, scope="module")
def on_cpu():
    prev = tdevice._current_device
    tp.set_device("cpu")
    yield
    tdevice._current_device = prev


DIVERGENT = {
    "vision/__init__.py": set(),
    "vision/datasets/__init__.py": set(),
    "vision/models/__init__.py": set(),
    "vision/models/extra.py": set(),
    "vision/models/extra2.py": set(),
    # jax.image.resize's weights, computed in torch
    "vision/transforms/__init__.py": {"Resize.__call__"},
}


@pytest.mark.parametrize("path", sorted(DIVERGENT))
def test_copy_matches_the_reference(path):
    assert differing_units(path) == DIVERGENT[path]


def _np(t):
    return np.asarray(t.numpy()) if hasattr(t, "numpy") else np.asarray(t)


# ---- models ------------------------------------------------------------------
CANONICAL = {
    "resnet18": 11_689_512, "resnet34": 21_797_672, "resnet50": 25_557_032,
    "resnet101": 44_549_160, "resnet152": 60_192_808,
    "resnext50_32x4d": 25_028_904, "resnext101_32x4d": 44_177_704,
    "resnext101_64x4d": 83_455_272, "wide_resnet50_2": 68_883_240,
    "wide_resnet101_2": 126_886_696, "vgg16": 138_357_544,
    "vgg19": 143_667_240, "mobilenet_v2": 3_504_872, "alexnet": 61_100_840,
    "densenet121": 7_978_856, "densenet161": 28_681_000,
    "densenet169": 14_149_480, "densenet201": 20_013_928,
    "squeezenet1_0": 1_248_424, "squeezenet1_1": 1_235_496,
    "shufflenet_v2_x0_25": 603_688, "shufflenet_v2_x0_5": 1_366_792,
    "shufflenet_v2_x1_0": 2_278_604, "shufflenet_v2_x1_5": 3_503_624,
    "shufflenet_v2_x2_0": 7_393_996, "shufflenet_v2_swish": 2_278_604,
    "mobilenet_v1": 4_231_976, "mobilenet_v3_large": 5_483_032,
    "mobilenet_v3_small": 2_542_856, "googlenet": 13_004_888,
    "inception_v3": 23_834_568,
}


@pytest.mark.parametrize("name", sorted(CANONICAL))
def test_factory_parameter_count(name):
    from paddle_tpu_torch.vision import models
    m = getattr(models, name)()
    assert sum(p.size for p in m.parameters()) == CANONICAL[name]


def test_lenet_count_and_forward():
    from paddle_tpu_torch.vision.models import LeNet
    m = LeNet()
    assert sum(p.size for p in m.parameters()) == 61_610
    x = tp.to_tensor(rng.rand(2, 1, 28, 28).astype(np.float32))
    assert m(x).shape == [2, 10]


@pytest.fixture
def _numpy_init(monkeypatch):
    """The JAX Layers' parameters drawn from a seeded numpy stream (He
    normal for weights, the initializer's constant for constants and
    biases)."""
    from paddle_tpu.nn import initializer as I
    from paddle_tpu.nn.layer.layers import Layer
    import jax.numpy as jnp
    orig, draw = Layer.create_parameter, np.random.RandomState(1)

    class _Numpy(I.Initializer):
        def __init__(self, default, is_bias):
            self.default, self.is_bias = default, is_bias

        def __call__(self, shape, dtype):
            if isinstance(self.default, I.Constant) or self.is_bias:
                v = getattr(self.default, "value", 0.0)
                return jnp.asarray(np.full(shape, v, np.float32))
            fan_in = int(np.prod(shape[1:])) if len(shape) > 1 else shape[0]
            return jnp.asarray((draw.standard_normal(shape)
                                * np.sqrt(2.0 / fan_in)).astype(np.float32))

    def create(self, shape, attr=None, dtype=None, is_bias=False,
               default_initializer=None):
        return orig(self, shape, attr, dtype, is_bias,
                    _Numpy(default_initializer, is_bias))
    monkeypatch.setattr(Layer, "create_parameter", create)


GRAD_FLOOR = 2e-6


def _train_step(pkg, model, x, y):
    """Train mode with dropout off; (logits, {name: grad}, {name: buffer})."""
    model.train()
    for m in model.sublayers():
        if type(m).__name__ == "Dropout":
            m.eval()
    out = model(pkg.to_tensor(x))
    loss = pkg.nn.functional.cross_entropy(out, pkg.to_tensor(y))
    loss.backward()
    grads = {n: _np(p.grad) for n, p in model.named_parameters()}
    bufs = {n: _np(b) for n, b in model.named_buffers()}
    return _np(out), grads, bufs


@pytest.mark.parametrize("name,kw", [
    ("resnet18", {}), ("mobilenet_v3_small", {"scale": 0.5})])
def test_train_step_against_jax(name, kw, _numpy_init):
    from paddle_tpu.vision import models as jmodels
    from paddle_tpu_torch.vision import models as tmodels
    jm = getattr(jmodels, name)(num_classes=10, **kw)
    tm = getattr(tmodels, name)(num_classes=10, **kw)
    state = {k: _np(v) for k, v in jm.state_dict().items()}
    assert tm.set_state_dict(state) == ([], [])
    x = np.random.RandomState(2).rand(2, 3, 64, 64).astype(np.float32)
    y = np.array([1, 7])
    got, want = _train_step(tp, tm, x, y), _train_step(pt, jm, x, y)
    np.testing.assert_allclose(got[0], want[0],
                               atol=1e-4 * np.abs(want[0]).max())
    assert got[1].keys() == want[1].keys() and len(got[1]) > 40
    for n, g in want[1].items():
        # a gradient that is zero but for rounding (a bias under a later
        # BatchNorm) is held at the floor
        np.testing.assert_allclose(got[1][n], g, atol=max(
            1e-4 * np.abs(g).max(), GRAD_FLOOR), err_msg=n)
    assert got[2].keys() == want[2].keys()
    stats = [n for n in want[2] if n.endswith(("_mean", "_variance"))]
    assert len(stats) >= 40
    for n in stats:
        assert not np.array_equal(want[2][n], state[n]), n   # they moved
        np.testing.assert_allclose(got[2][n], want[2][n], atol=1e-5,
                                   rtol=1e-5, err_msg=n)


class TestModelZoo:
    """The reference's ``test_vision_extra.py`` zoo classes on the port."""

    def test_vgg16_params_and_forward(self):
        from paddle_tpu_torch.vision.models import vgg16
        m = vgg16(num_classes=10)
        m.eval()
        assert sum(p.size for p in m.parameters()) == 134_301_514
        x = tp.to_tensor(rng.rand(1, 3, 64, 64).astype(np.float32))
        assert m(x).shape == [1, 10]

    def test_mobilenet_v2_params_and_train_step(self):
        from paddle_tpu_torch.vision.models import mobilenet_v2
        m = mobilenet_v2(num_classes=10)
        assert sum(p.size for p in m.parameters()) == 2_236_682
        opt = tp.optimizer.SGD(learning_rate=0.01, parameters=m.parameters())
        x = tp.to_tensor(rng.rand(2, 3, 32, 32).astype(np.float32))
        y = tp.to_tensor(rng.randint(0, 10, (2,)))
        loss = tp.nn.CrossEntropyLoss()(m(x), y)
        loss.backward()
        opt.step()
        assert np.isfinite(float(loss))

    def test_alexnet_forward(self):
        from paddle_tpu_torch.vision.models import alexnet
        m = alexnet(num_classes=10)
        m.eval()
        assert sum(p.size for p in m.parameters()) == 57_044_810
        x = tp.to_tensor(rng.rand(1, 3, 64, 64).astype(np.float32))
        assert m(x).shape == [1, 10]

    @pytest.mark.parametrize("name", [
        "squeezenet1_1", "shufflenet_v2_x1_0", "mobilenet_v3_small",
        "mobilenet_v1", "densenet121", "resnext50_32x4d"])
    def test_forward_shape(self, name):
        from paddle_tpu_torch.vision import models
        m = getattr(models, name)()
        m.eval()
        x = tp.to_tensor(rng.rand(1, 3, 64, 64).astype(np.float32))
        assert m(x).shape == [1, 1000]

    def test_googlenet_aux_heads(self):
        from paddle_tpu_torch.vision.models import googlenet
        g = googlenet(num_classes=10)
        assert sum(p.size for p in g.parameters()) == 13_004_888 - \
            (1000 - 10) * (1024 + 1024 + 1024 + 3)
        g.train()
        x = tp.to_tensor(rng.rand(1, 3, 64, 64).astype(np.float32))
        out, a1, a2 = g(x)
        assert out.shape == [1, 10] and a1.shape == [1, 10] \
            and a2.shape == [1, 10]
        g.eval()
        assert g(x).shape == [1, 10]


# ---- ops ---------------------------------------------------------------------
def _boxes(n, seed, size=100.0):
    r = np.random.RandomState(seed)
    xy = r.uniform(0, size, (n, 2))
    wh = r.uniform(2, size / 3, (n, 2))
    return np.concatenate([xy, xy + wh], 1).astype(np.float32)


def test_box_area_and_iou_against_jax():
    from paddle_tpu.vision import ops as jops
    from paddle_tpu_torch.vision import ops as tops
    a, b = _boxes(7, 1), _boxes(5, 2)
    np.testing.assert_allclose(_np(tops.box_area(tp.to_tensor(a))),
                               _np(jops.box_area(pt.to_tensor(a))),
                               rtol=1e-6)
    np.testing.assert_allclose(
        _np(tops.box_iou(tp.to_tensor(a), tp.to_tensor(b))),
        _np(jops.box_iou(pt.to_tensor(a), pt.to_tensor(b))), atol=1e-6)


@pytest.mark.parametrize("case", ["plain", "ties", "categories", "top_k",
                                  "no_scores"])
def test_nms_against_jax(case):
    from paddle_tpu.vision import ops as jops
    from paddle_tpu_torch.vision import ops as tops
    n = 300
    boxes = _boxes(n, 3)
    scores = np.random.RandomState(4).rand(n).astype(np.float32)
    if case == "ties":
        scores = np.round(scores * 8) / 8
    kw = {}
    if case == "categories":
        cats = np.random.RandomState(5).randint(0, 4, n)
        kw = dict(category_idxs=cats, categories=[0, 1, 2, 3])
    if case == "top_k":
        kw = dict(top_k=20)
    res = []
    for pkg, ops in ((tp, tops), (pt, jops)):
        k = {key: (pkg.to_tensor(v) if key == "category_idxs" else v)
             for key, v in kw.items()}
        s = None if case == "no_scores" else pkg.to_tensor(scores)
        res.append(_np(ops.nms(pkg.to_tensor(boxes), 0.3, s, **k)))
    assert len(res[0]) > 10
    np.testing.assert_array_equal(res[0], res[1])


ROI = [
    dict(output_size=4, spatial_scale=0.25),
    dict(output_size=(3, 5), spatial_scale=0.25, aligned=False),
    dict(output_size=2, spatial_scale=0.5, sampling_ratio=3),
]


def _roi_inputs():
    x = np.random.RandomState(6).randn(2, 3, 12, 14).astype(np.float32)
    boxes = np.array([[4, 4, 40, 30], [0, 0, 55, 47], [-8, 10, 20, 70],
                      [30, 2, 33, 5], [10, 12, 52, 44]], np.float32)
    return x, boxes, np.array([2, 3])


@pytest.mark.parametrize("kw", ROI, ids=range(len(ROI)))
def test_roi_align_and_gradients_against_jax(kw):
    from paddle_tpu.vision import ops as jops
    from paddle_tpu_torch.vision import ops as tops
    x, boxes, num = _roi_inputs()
    res = []
    for pkg, ops in ((tp, tops), (pt, jops)):
        tx = pkg.to_tensor(x, stop_gradient=False)
        tb = pkg.to_tensor(boxes, stop_gradient=False)
        out = ops.roi_align(tx, tb, pkg.to_tensor(num), **kw)
        w = np.random.RandomState(8).rand(*out.shape).astype(np.float32)
        (out * pkg.to_tensor(w)).sum().backward()
        res.append((_np(out), _np(tx.grad), _np(tb.grad)))
    for got, want in zip(*res):
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want,
                                   atol=1e-5 * max(np.abs(want).max(), 1))


@pytest.mark.parametrize("out_size", [1, 3, (2, 4)])
def test_roi_pool_and_gradient_against_jax(out_size):
    from paddle_tpu.vision import ops as jops
    from paddle_tpu_torch.vision import ops as tops
    x, boxes, num = _roi_inputs()
    res = []
    for pkg, ops in ((tp, tops), (pt, jops)):
        tx = pkg.to_tensor(x, stop_gradient=False)
        out = ops.roi_pool(tx, pkg.to_tensor(boxes), pkg.to_tensor(num),
                           out_size, spatial_scale=0.25)
        w = np.random.RandomState(9).rand(*out.shape).astype(np.float32)
        (out * pkg.to_tensor(w)).sum().backward()
        res.append((_np(out), _np(tx.grad)))
    for got, want in zip(*res):
        np.testing.assert_allclose(got, want, atol=1e-5)


class TestVisionOps:
    """The reference's ``test_vision_extra.py::TestVisionOps`` on the port."""

    def test_nms_matches_greedy_reference(self):
        from paddle_tpu_torch.vision.ops import nms
        boxes = np.array([[0, 0, 10, 10], [1, 1, 11, 11], [20, 20, 30, 30],
                          [21, 21, 29, 29], [50, 50, 60, 60]], np.float32)
        scores = np.array([0.9, 0.8, 0.7, 0.95, 0.5], np.float32)
        kept = nms(tp.to_tensor(boxes), iou_threshold=0.5,
                   scores=tp.to_tensor(scores)).numpy()
        assert kept.tolist() == [3, 0, 4]

    def test_nms_category_aware(self):
        from paddle_tpu_torch.vision.ops import nms
        boxes = np.array([[0, 0, 10, 10], [1, 1, 11, 11]], np.float32)
        kept = nms(tp.to_tensor(boxes), iou_threshold=0.3,
                   scores=tp.to_tensor(np.array([0.9, 0.8], np.float32)),
                   category_idxs=tp.to_tensor(np.array([0, 1])),
                   categories=[0, 1]).numpy()
        assert sorted(kept.tolist()) == [0, 1]

    def test_box_iou(self):
        from paddle_tpu_torch.vision.ops import box_iou
        a = np.array([[0, 0, 10, 10]], np.float32)
        b = np.array([[0, 0, 10, 10], [5, 5, 15, 15], [20, 20, 30, 30]],
                     np.float32)
        iou = box_iou(tp.to_tensor(a), tp.to_tensor(b)).numpy()
        np.testing.assert_allclose(iou[0], [1.0, 25 / 175, 0.0], atol=1e-5)

    def test_roi_align_constant_field(self):
        from paddle_tpu_torch.vision.ops import roi_align
        x = tp.to_tensor(np.full((1, 2, 16, 16), 3.0, np.float32))
        boxes = tp.to_tensor(np.array([[2, 2, 10, 10]], np.float32))
        out = roi_align(x, boxes, tp.to_tensor(np.array([1])), 4,
                        spatial_scale=1.0)
        assert out.shape == [1, 2, 4, 4]
        np.testing.assert_allclose(out.numpy(), 3.0, rtol=1e-6)

    def test_roi_align_gradient_flows(self):
        from paddle_tpu_torch.vision.ops import roi_align
        x = tp.to_tensor(rng.rand(1, 2, 8, 8).astype(np.float32),
                         stop_gradient=False)
        boxes = tp.to_tensor(np.array([[1, 1, 6, 6]], np.float32))
        roi_align(x, boxes, tp.to_tensor(np.array([1])), 2).sum().backward()
        assert x.grad is not None and float(np.abs(x.grad.numpy()).sum()) > 0

    def test_roi_pool_takes_max(self):
        from paddle_tpu_torch.vision.ops import roi_pool
        feat = np.zeros((1, 1, 8, 8), np.float32)
        feat[0, 0, 3, 3] = 7.0
        out = roi_pool(tp.to_tensor(feat),
                       tp.to_tensor(np.array([[0, 0, 7, 7]], np.float32)),
                       tp.to_tensor(np.array([1])), 1)
        assert float(out.numpy().max()) == 7.0

    def test_multi_image_roi_assignment(self):
        from paddle_tpu_torch.vision.ops import roi_align
        x = np.zeros((2, 1, 8, 8), np.float32)
        x[0] = 1.0
        x[1] = 5.0
        boxes = np.array([[0, 0, 7, 7], [0, 0, 7, 7]], np.float32)
        out = roi_align(tp.to_tensor(x), tp.to_tensor(boxes),
                        tp.to_tensor(np.array([1, 1])), 2)
        np.testing.assert_allclose(out.numpy()[0], 1.0, rtol=1e-5)
        np.testing.assert_allclose(out.numpy()[1], 5.0, rtol=1e-5)


# ---- transforms --------------------------------------------------------------
def _img(chw=False, dtype=np.uint8, h=20, w=24):
    a = np.random.RandomState(12).randint(0, 256, (h, w, 3))
    a = a.transpose(2, 0, 1) if chw else a
    return a.astype(dtype)


TRANSFORMS = [
    ("Compose", lambda T: T.Compose([T.Resize(12), T.Transpose()]), {}),
    ("Normalize", lambda T: T.Normalize([120, 110, 100], [50, 60, 70]),
     dict(chw=True)),
    ("Normalize_hwc", lambda T: T.Normalize(100.0, 40.0, data_format="HWC"),
     {}),
    ("ToTensor", lambda T: T.ToTensor(), {}),
    ("Resize_down", lambda T: T.Resize((9, 13)), {}),
    ("Resize_up_chw", lambda T: T.Resize(31), dict(chw=True)),
    ("Resize_mixed", lambda T: T.Resize((40, 10)), dict(dtype=np.float32)),
    ("RandomHorizontalFlip", lambda T: T.RandomHorizontalFlip(0.5), {}),
    ("RandomCrop", lambda T: T.RandomCrop(12, padding=2), {}),
    ("CenterCrop", lambda T: T.CenterCrop(10), {}),
    ("RandomVerticalFlip", lambda T: T.RandomVerticalFlip(0.5), {}),
    ("Pad", lambda T: T.Pad(3, fill=7), {}),
    ("Pad_reflect", lambda T: T.Pad((1, 2), padding_mode="reflect"), {}),
    ("Grayscale", lambda T: T.Grayscale(3), {}),
    ("BrightnessTransform", lambda T: T.BrightnessTransform(0.4), {}),
    ("ContrastTransform", lambda T: T.ContrastTransform(0.4), {}),
    ("SaturationTransform", lambda T: T.SaturationTransform(0.4), {}),
    ("ColorJitter", lambda T: T.ColorJitter(0.3, 0.3, 0.3, 0.1), {}),
    ("RandomRotation", lambda T: T.RandomRotation(30), {}),
    ("RandomResizedCrop", lambda T: T.RandomResizedCrop(16), {}),
    ("Transpose", lambda T: T.Transpose(), {}),
    ("HueTransform", lambda T: T.HueTransform(0.2), {}),
    ("RandomAffine", lambda T: T.RandomAffine(20, translate=(0.1, 0.1),
                                             scale=(0.8, 1.2), shear=5), {}),
    ("RandomPerspective", lambda T: T.RandomPerspective(1.0), {}),
    ("RandomErasing", lambda T: T.RandomErasing(1.0), dict(chw=True)),
    ("hflip", lambda T: T.hflip, {}),
    ("vflip", lambda T: T.vflip, {}),
    ("crop", lambda T: lambda a: T.crop(a, 2, 3, 8, 9), {}),
    ("center_crop", lambda T: lambda a: T.center_crop(a, 8), {}),
    ("resize", lambda T: lambda a: T.resize(a, (10, 30)), {}),
    ("to_tensor", lambda T: T.to_tensor, {}),
    ("normalize", lambda T: lambda a: T.normalize(a, 100, 50), {}),
    ("adjust_brightness", lambda T: lambda a: T.adjust_brightness(a, 1.3),
     {}),
    ("adjust_contrast", lambda T: lambda a: T.adjust_contrast(a, 0.7), {}),
    ("adjust_saturation", lambda T: lambda a: T.adjust_saturation(a, 1.4),
     {}),
    ("adjust_hue", lambda T: lambda a: T.adjust_hue(a, -0.2), {}),
    ("to_grayscale", lambda T: T.to_grayscale, {}),
    ("rotate", lambda T: lambda a: T.rotate(a, 33, expand=True), {}),
    ("affine", lambda T: lambda a: T.affine(a, 10, (2, 1), 1.1, (3.0, 2.0)),
     {}),
    ("perspective", lambda T: lambda a: T.perspective(
        a, [[0, 0], [23, 0], [23, 19], [0, 19]],
        [[2, 1], [21, 3], [22, 18], [1, 17]]), {}),
    ("erase", lambda T: lambda a: T.erase(a, 2, 3, 5, 6, 0), {}),
    ("pad", lambda T: lambda a: T.pad(a, (1, 2, 3, 4), padding_mode="edge"),
     {}),
]


@pytest.mark.parametrize("name,make,img", TRANSFORMS,
                         ids=[t[0] for t in TRANSFORMS])
def test_transform_against_jax(name, make, img):
    from paddle_tpu.vision import transforms as JT
    from paddle_tpu_torch.vision import transforms as TT
    outs = []
    for T in (TT, JT):
        np.random.seed(21)
        outs.append(np.asarray(make(T)(_img(**img))))
    assert outs[0].shape == outs[1].shape and outs[0].dtype == outs[1].dtype
    np.testing.assert_allclose(outs[0].astype(np.float64),
                               outs[1].astype(np.float64), atol=1e-5,
                               rtol=1e-6)


def test_random_erasing_on_a_tensor():
    from paddle_tpu_torch.vision import transforms as TT
    np.random.seed(3)
    t = tp.to_tensor(np.ones((3, 16, 16), np.float32))
    out = TT.RandomErasing(1.0, value=0.0)(t)
    assert isinstance(out, tp.Tensor) and (out.numpy() == 0).any()
    assert (t.numpy() == 1).all()


# ---- datasets ----------------------------------------------------------------
def _same_items(a, b):
    assert len(a) == len(b)
    for i in range(len(a)):
        for u, v in zip(a[i], b[i]):
            np.testing.assert_array_equal(np.asarray(u), np.asarray(v))


class TestVisionDatasets:
    def _write_idx(self, tmp, images, labels):
        ip = os.path.join(tmp, "img.idx.gz")
        lp = os.path.join(tmp, "lbl.idx.gz")
        with gzip.open(ip, "wb") as f:
            f.write(struct.pack(">IIII", 2051, *images.shape))
            f.write(images.tobytes())
        with gzip.open(lp, "wb") as f:
            f.write(struct.pack(">II", 2049, len(labels)))
            f.write(labels.tobytes())
        return ip, lp

    @pytest.mark.parametrize("cls", ["MNIST", "FashionMNIST"])
    def test_mnist_idx_parsing(self, tmp_path, cls):
        from paddle_tpu.vision import datasets as JD
        from paddle_tpu_torch.vision import datasets as TD
        imgs = rng.randint(0, 255, (10, 28, 28)).astype(np.uint8)
        lbls = rng.randint(0, 10, 10).astype(np.uint8)
        ip, lp = self._write_idx(str(tmp_path), imgs, lbls)
        ds = getattr(TD, cls)(image_path=ip, label_path=lp)
        assert len(ds) == 10
        x, y = ds[3]
        np.testing.assert_allclose(x, imgs[3].astype(np.float32))
        assert y == int(lbls[3])
        _same_items(ds, getattr(JD, cls)(image_path=ip, label_path=lp))

    @pytest.mark.parametrize("cls,member,key", [
        ("Cifar10", "cifar-10-batches-py/data_batch_1", b"labels"),
        ("Cifar100", "cifar-100-python/train", b"fine_labels")])
    def test_cifar_tar_parsing(self, tmp_path, cls, member, key):
        from paddle_tpu.vision import datasets as JD
        from paddle_tpu_torch.vision import datasets as TD
        data = rng.randint(0, 255, (8, 3072)).astype(np.uint8)
        labels = rng.randint(0, 10, 8).tolist()
        tarp = str(tmp_path / "cifar.tar.gz")
        with tarfile.open(tarp, "w:gz") as tf:
            payload = pickle.dumps({b"data": data, key: labels})
            ti = tarfile.TarInfo(member)
            ti.size = len(payload)
            tf.addfile(ti, _io.BytesIO(payload))
        ds = getattr(TD, cls)(data_file=tarp, mode="train")
        assert len(ds) == 8
        x, y = ds[0]
        assert x.shape == (3, 32, 32) and y == labels[0]
        _same_items(ds, getattr(JD, cls)(data_file=tarp, mode="train"))

    @pytest.mark.parametrize("cls", ["MNIST", "Flowers", "VOC2012"])
    def test_missing_file_raises_clearly(self, cls):
        from paddle_tpu_torch.vision import datasets as TD
        kw = dict(image_path="/nonexistent", label_path="/nonexistent") \
            if cls == "MNIST" else {}
        with pytest.raises(RuntimeError, match="cannot download"):
            getattr(TD, cls)(**kw)

    def test_dataset_folder(self, tmp_path):
        from paddle_tpu.vision.datasets import DatasetFolder as JDF
        from paddle_tpu_torch.vision.datasets import DatasetFolder
        for c in ("cat", "dog"):
            os.makedirs(tmp_path / c)
            for i in range(3):
                np.save(tmp_path / c / f"{i}.npy",
                        rng.rand(4, 4).astype(np.float32))
        ds = DatasetFolder(str(tmp_path))
        assert len(ds) == 6 and ds.classes == ["cat", "dog"]
        x, y = ds[0]
        assert x.shape == (4, 4) and y == 0
        _same_items(ds, JDF(str(tmp_path)))

    def test_image_folder_with_a_transform(self, tmp_path):
        from paddle_tpu_torch.vision import transforms as TT
        from paddle_tpu_torch.vision.datasets import ImageFolder
        os.makedirs(tmp_path / "a" / "b")
        np.save(tmp_path / "a" / "0.npy", _img())
        np.save(tmp_path / "a" / "b" / "1.npy", _img(h=30))
        ds = ImageFolder(str(tmp_path), transform=TT.Compose(
            [TT.Resize(8), TT.Transpose()]))
        assert len(ds) == 2
        assert [ds[i][0].shape for i in range(2)] == [(3, 8, 8)] * 2


# ---- the image backend -------------------------------------------------------
def test_image_backend_and_load(tmp_path):
    from PIL import Image
    from paddle_tpu_torch import vision
    assert vision.get_image_backend() == "pil"
    with pytest.raises(ValueError, match="backend"):
        vision.set_image_backend("tiff")
    p = str(tmp_path / "x.png")
    Image.fromarray(_img()).save(p)
    np.testing.assert_array_equal(np.asarray(vision.image_load(p)), _img())
    vision.set_image_backend("pil")
