"""VGG / MobileNetV2 / AlexNet (reference: python/paddle/vision/models/
vgg.py, mobilenetv2.py, alexnet.py — same topologies on the paddle_tpu_torch.nn
stack; conv stacks fuse under jit and land on the MXU as implicit GEMMs)."""
from __future__ import annotations

from ...nn.layer.layers import Layer
from ...nn.layer.common import Linear, Dropout
from ...nn.layer.conv import Conv2D
from ...nn.layer.norm import BatchNorm2D
from ...nn.layer.pooling import MaxPool2D, AdaptiveAvgPool2D
from ...nn.layer.container import Sequential
from ...nn.layer.activation import ReLU, ReLU6
from ... import ops

__all__ = ["VGG", "vgg16", "vgg19", "MobileNetV2", "mobilenet_v2",
           "AlexNet", "alexnet"]

_VGG_CFGS = {
    "D": [64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
          512, 512, 512, "M", 512, 512, 512, "M"],            # vgg16
    "E": [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
          512, 512, 512, 512, "M", 512, 512, 512, 512, "M"],  # vgg19
}


def _vgg_features(cfg, batch_norm=False):
    layers, c_in = [], 3
    for v in cfg:
        if v == "M":
            layers.append(MaxPool2D(kernel_size=2, stride=2))
        else:
            layers.append(Conv2D(c_in, v, 3, padding=1))
            if batch_norm:
                layers.append(BatchNorm2D(v))
            layers.append(ReLU())
            c_in = v
    return Sequential(*layers)


class VGG(Layer):
    """reference: vision/models/vgg.py VGG."""

    def __init__(self, features, num_classes=1000, with_pool=True):
        super().__init__()
        self.features = features
        self.with_pool = with_pool
        if with_pool:
            self.avgpool = AdaptiveAvgPool2D((7, 7))
        if num_classes > 0:
            self.classifier = Sequential(
                Linear(512 * 7 * 7, 4096), ReLU(), Dropout(),
                Linear(4096, 4096), ReLU(), Dropout(),
                Linear(4096, num_classes))
        self.num_classes = num_classes

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.avgpool(x)
        if self.num_classes > 0:
            x = ops.flatten(x, 1)
            x = self.classifier(x)
        return x


def vgg16(pretrained=False, batch_norm=False, **kwargs):
    return VGG(_vgg_features(_VGG_CFGS["D"], batch_norm), **kwargs)


def vgg19(pretrained=False, batch_norm=False, **kwargs):
    return VGG(_vgg_features(_VGG_CFGS["E"], batch_norm), **kwargs)


class _InvertedResidual(Layer):
    def __init__(self, inp, oup, stride, expand_ratio):
        super().__init__()
        self.stride = stride
        hidden = int(round(inp * expand_ratio))
        self.use_res = stride == 1 and inp == oup
        layers = []
        if expand_ratio != 1:
            layers += [Conv2D(inp, hidden, 1, bias_attr=False),
                       BatchNorm2D(hidden), ReLU6()]
        layers += [
            Conv2D(hidden, hidden, 3, stride=stride, padding=1,
                   groups=hidden, bias_attr=False),
            BatchNorm2D(hidden), ReLU6(),
            Conv2D(hidden, oup, 1, bias_attr=False), BatchNorm2D(oup),
        ]
        self.conv = Sequential(*layers)

    def forward(self, x):
        out = self.conv(x)
        return x + out if self.use_res else out


def _make_divisible(v, divisor=8, min_value=None):
    """reference: mobilenetv2.py _make_divisible — round channel counts to
    multiples of 8, never dropping more than 10%."""
    min_value = min_value or divisor
    new_v = max(min_value, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


class MobileNetV2(Layer):
    """reference: vision/models/mobilenetv2.py MobileNetV2."""

    def __init__(self, scale=1.0, num_classes=1000, with_pool=True):
        super().__init__()
        cfg = [(1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
               (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1)]
        inp = _make_divisible(32 * scale)
        last = _make_divisible(1280 * max(1.0, scale))
        feats = [Conv2D(3, inp, 3, stride=2, padding=1, bias_attr=False),
                 BatchNorm2D(inp), ReLU6()]
        for t, c, n, s in cfg:
            out_c = _make_divisible(c * scale)
            for i in range(n):
                feats.append(_InvertedResidual(inp, out_c,
                                               s if i == 0 else 1, t))
                inp = out_c
        feats += [Conv2D(inp, last, 1, bias_attr=False), BatchNorm2D(last),
                  ReLU6()]
        self.features = Sequential(*feats)
        self.with_pool = with_pool
        self.num_classes = num_classes
        if with_pool:
            self.pool2d_avg = AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.classifier = Sequential(Dropout(0.2), Linear(last,
                                                              num_classes))
        self._last = last

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.pool2d_avg(x)
        if self.num_classes > 0:
            x = ops.reshape(x, [x.shape[0], self._last])
            x = self.classifier(x)
        return x


def mobilenet_v2(pretrained=False, scale=1.0, **kwargs):
    return MobileNetV2(scale=scale, **kwargs)


class AlexNet(Layer):
    """reference: vision/models/alexnet.py."""

    def __init__(self, num_classes=1000):
        super().__init__()
        self.features = Sequential(
            Conv2D(3, 64, 11, stride=4, padding=2), ReLU(),
            MaxPool2D(kernel_size=3, stride=2),
            Conv2D(64, 192, 5, padding=2), ReLU(),
            MaxPool2D(kernel_size=3, stride=2),
            Conv2D(192, 384, 3, padding=1), ReLU(),
            Conv2D(384, 256, 3, padding=1), ReLU(),
            Conv2D(256, 256, 3, padding=1), ReLU(),
            MaxPool2D(kernel_size=3, stride=2))
        self.avgpool = AdaptiveAvgPool2D((6, 6))
        self.classifier = Sequential(
            Dropout(), Linear(256 * 6 * 6, 4096), ReLU(),
            Dropout(), Linear(4096, 4096), ReLU(),
            Linear(4096, num_classes))

    def forward(self, x):
        x = self.features(x)
        x = self.avgpool(x)
        x = ops.flatten(x, 1)
        return self.classifier(x)


def alexnet(pretrained=False, **kwargs):
    return AlexNet(**kwargs)
