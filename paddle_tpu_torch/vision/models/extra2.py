"""Vision zoo, part 3 (reference: python/paddle/vision/models/{densenet,
squeezenet,shufflenetv2,mobilenetv1,mobilenetv3,googlenet,inceptionv3}.py).

Standard published architectures, written against paddle_tpu_torch.nn. NCHW.
"""
from __future__ import annotations

from ...nn.layer.layers import Layer
from ...nn.layer.common import Linear, Dropout
from ...nn.layer.conv import Conv2D
from ...nn.layer.norm import BatchNorm2D
from ...nn.layer.pooling import AdaptiveAvgPool2D
from ...nn import Sequential, ReLU, MaxPool2D, AvgPool2D, Hardswish
from ... import ops
from ...nn import functional as F
from .extra import _make_divisible


class ConvBNLayer(Layer):
    """conv -> BN -> optional activation (the zoo's shared stem block)."""

    def __init__(self, cin, cout, k, stride=1, padding=0, groups=1, act="relu"):
        super().__init__()
        self.conv = Conv2D(cin, cout, k, stride=stride, padding=padding,
                           groups=groups, bias_attr=False)
        self.bn = BatchNorm2D(cout)
        self.act = act

    def forward(self, x):
        x = self.bn(self.conv(x))
        if self.act is not None:
            x = getattr(F, self.act)(x)   # relu / hardswish / swish / ...
        return x


# ---- DenseNet (densenet.py) --------------------------------------------------
class _DenseLayer(Layer):
    def __init__(self, cin, growth, bn_size=4, drop=0.0):
        super().__init__()
        self.bn1 = BatchNorm2D(cin)
        self.conv1 = Conv2D(cin, bn_size * growth, 1, bias_attr=False)
        self.bn2 = BatchNorm2D(bn_size * growth)
        self.conv2 = Conv2D(bn_size * growth, growth, 3, padding=1,
                            bias_attr=False)
        self.drop = drop

    def forward(self, x):
        y = self.conv1(F.relu(self.bn1(x)))
        y = self.conv2(F.relu(self.bn2(y)))
        if self.drop:
            y = F.dropout(y, p=self.drop, training=self.training)
        return ops.concat([x, y], axis=1)


class _Transition(Layer):
    def __init__(self, cin, cout):
        super().__init__()
        self.bn = BatchNorm2D(cin)
        self.conv = Conv2D(cin, cout, 1, bias_attr=False)
        self.pool = AvgPool2D(2, stride=2)

    def forward(self, x):
        return self.pool(self.conv(F.relu(self.bn(x))))


class DenseNet(Layer):
    """reference densenet.py; canonical growth-rate dense blocks."""

    def __init__(self, layers=121, growth_rate=None, num_init_features=None,
                 bn_size=4, dropout=0.0, num_classes=1000, with_pool=True):
        super().__init__()
        cfgs = {121: (6, 12, 24, 16), 161: (6, 12, 36, 24),
                169: (6, 12, 32, 32), 201: (6, 12, 48, 32),
                264: (6, 12, 64, 48)}
        # 161 is the wide variant; None means "canonical for this depth" so
        # explicit caller overrides are honored
        if growth_rate is None:
            growth_rate = 48 if layers == 161 else 32
        if num_init_features is None:
            num_init_features = 96 if layers == 161 else 64
        block_cfg = cfgs[layers]
        self.stem = Sequential(
            Conv2D(3, num_init_features, 7, stride=2, padding=3,
                   bias_attr=False),
            BatchNorm2D(num_init_features), ReLU(),
            MaxPool2D(3, stride=2, padding=1))
        c = num_init_features
        blocks = []
        for i, n in enumerate(block_cfg):
            for _ in range(n):
                blocks.append(_DenseLayer(c, growth_rate, bn_size, dropout))
                c += growth_rate
            if i != len(block_cfg) - 1:
                blocks.append(_Transition(c, c // 2))
                c //= 2
        self.blocks = Sequential(*blocks)
        self.bn_final = BatchNorm2D(c)
        self.with_pool = with_pool
        self.pool = AdaptiveAvgPool2D(1)
        self.fc = Linear(c, num_classes) if num_classes > 0 else None

    def forward(self, x):
        x = F.relu(self.bn_final(self.blocks(self.stem(x))))
        if self.with_pool:
            x = self.pool(x)
        if self.fc is not None:
            x = self.fc(x.flatten(1))
        return x


def densenet121(pretrained=False, **kw):
    return DenseNet(121, **kw)


def densenet161(pretrained=False, **kw):
    return DenseNet(161, **kw)


def densenet169(pretrained=False, **kw):
    return DenseNet(169, **kw)


def densenet201(pretrained=False, **kw):
    return DenseNet(201, **kw)


# ---- SqueezeNet (squeezenet.py) ---------------------------------------------
class _Fire(Layer):
    def __init__(self, cin, squeeze, e1, e3):
        super().__init__()
        self.squeeze = Conv2D(cin, squeeze, 1)
        self.e1 = Conv2D(squeeze, e1, 1)
        self.e3 = Conv2D(squeeze, e3, 3, padding=1)

    def forward(self, x):
        s = F.relu(self.squeeze(x))
        return ops.concat([F.relu(self.e1(s)), F.relu(self.e3(s))], axis=1)


class SqueezeNet(Layer):
    """reference squeezenet.py (versions '1.0' / '1.1')."""

    def __init__(self, version="1.0", num_classes=1000, with_pool=True):
        super().__init__()
        v = str(version)
        if v == "1.0":
            self.features = Sequential(
                Conv2D(3, 96, 7, stride=2), ReLU(),
                MaxPool2D(3, stride=2),
                _Fire(96, 16, 64, 64), _Fire(128, 16, 64, 64),
                _Fire(128, 32, 128, 128), MaxPool2D(3, stride=2),
                _Fire(256, 32, 128, 128), _Fire(256, 48, 192, 192),
                _Fire(384, 48, 192, 192), _Fire(384, 64, 256, 256),
                MaxPool2D(3, stride=2), _Fire(512, 64, 256, 256))
        elif v == "1.1":
            self.features = Sequential(
                Conv2D(3, 64, 3, stride=2), ReLU(),
                MaxPool2D(3, stride=2),
                _Fire(64, 16, 64, 64), _Fire(128, 16, 64, 64),
                MaxPool2D(3, stride=2),
                _Fire(128, 32, 128, 128), _Fire(256, 32, 128, 128),
                MaxPool2D(3, stride=2),
                _Fire(256, 48, 192, 192), _Fire(384, 48, 192, 192),
                _Fire(384, 64, 256, 256), _Fire(512, 64, 256, 256))
        else:
            raise ValueError(f"unsupported SqueezeNet version {version!r}")
        self.drop = Dropout(0.5)
        self.final_conv = Conv2D(512, num_classes, 1)
        self.with_pool = with_pool
        self.pool = AdaptiveAvgPool2D(1)

    def forward(self, x):
        x = F.relu(self.final_conv(self.drop(self.features(x))))
        if self.with_pool:
            x = self.pool(x)
        return x.flatten(1)


def squeezenet1_0(pretrained=False, **kw):
    return SqueezeNet("1.0", **kw)


def squeezenet1_1(pretrained=False, **kw):
    return SqueezeNet("1.1", **kw)


# ---- ShuffleNetV2 (shufflenetv2.py) -----------------------------------------
def _channel_shuffle(x, groups):
    b, c, h, w = x.shape
    x = x.reshape([b, groups, c // groups, h, w])
    x = x.transpose([0, 2, 1, 3, 4])
    return x.reshape([b, c, h, w])


class _ShuffleUnit(Layer):
    def __init__(self, cin, cout, stride, act="relu"):
        super().__init__()
        self.stride = stride
        branch = cout // 2
        if stride == 2:
            self.b1 = Sequential(
                ConvBNLayer(cin, cin, 3, stride=2, padding=1, groups=cin,
                            act=None),
                ConvBNLayer(cin, branch, 1, act=act))
            c2_in = cin
        else:
            self.b1 = None
            c2_in = cin // 2
        self.b2 = Sequential(
            ConvBNLayer(c2_in, branch, 1, act=act),
            ConvBNLayer(branch, branch, 3, stride=stride, padding=1,
                        groups=branch, act=None),
            ConvBNLayer(branch, branch, 1, act=act))

    def forward(self, x):
        if self.stride == 2:
            out = ops.concat([self.b1(x), self.b2(x)], axis=1)
        else:
            half = x.shape[1] // 2
            x1, x2 = x[:, :half], x[:, half:]
            out = ops.concat([x1, self.b2(x2)], axis=1)
        return _channel_shuffle(out, 2)


class ShuffleNetV2(Layer):
    """reference shufflenetv2.py (scale 0.25-2.0 + swish variant)."""

    _CHANNELS = {0.25: (24, 24, 48, 96, 512), 0.33: (24, 32, 64, 128, 512),
                 0.5: (24, 48, 96, 192, 1024), 1.0: (24, 116, 232, 464, 1024),
                 1.5: (24, 176, 352, 704, 1024), 2.0: (24, 244, 488, 976, 2048)}

    def __init__(self, scale=1.0, act="relu", num_classes=1000, with_pool=True):
        super().__init__()
        chans = self._CHANNELS[float(scale)]
        repeats = (4, 8, 4)
        self.stem = Sequential(
            ConvBNLayer(3, chans[0], 3, stride=2, padding=1, act=act),
            MaxPool2D(3, stride=2, padding=1))
        units = []
        cin = chans[0]
        for stage, n in enumerate(repeats):
            cout = chans[stage + 1]
            units.append(_ShuffleUnit(cin, cout, stride=2, act=act))
            for _ in range(n - 1):
                units.append(_ShuffleUnit(cout, cout, stride=1, act=act))
            cin = cout
        self.units = Sequential(*units)
        self.conv_last = ConvBNLayer(cin, chans[4], 1, act=act)
        self.with_pool = with_pool
        self.pool = AdaptiveAvgPool2D(1)
        self.fc = Linear(chans[4], num_classes) if num_classes > 0 else None

    def forward(self, x):
        x = self.conv_last(self.units(self.stem(x)))
        if self.with_pool:
            x = self.pool(x)
        if self.fc is not None:
            x = self.fc(x.flatten(1))
        return x


def shufflenet_v2_x0_25(pretrained=False, **kw):
    return ShuffleNetV2(0.25, **kw)


def shufflenet_v2_x0_5(pretrained=False, **kw):
    return ShuffleNetV2(0.5, **kw)


def shufflenet_v2_x1_0(pretrained=False, **kw):
    return ShuffleNetV2(1.0, **kw)


def shufflenet_v2_x1_5(pretrained=False, **kw):
    return ShuffleNetV2(1.5, **kw)


def shufflenet_v2_x2_0(pretrained=False, **kw):
    return ShuffleNetV2(2.0, **kw)


def shufflenet_v2_swish(pretrained=False, **kw):
    return ShuffleNetV2(1.0, act="swish", **kw)


# ---- MobileNetV1 (mobilenetv1.py) -------------------------------------------
class _DepthwiseSeparable(Layer):
    def __init__(self, cin, cout, stride):
        super().__init__()
        self.dw = ConvBNLayer(cin, cin, 3, stride=stride, padding=1,
                              groups=cin)
        self.pw = ConvBNLayer(cin, cout, 1)

    def forward(self, x):
        return self.pw(self.dw(x))


class MobileNetV1(Layer):
    """reference mobilenetv1.py."""

    def __init__(self, scale=1.0, num_classes=1000, with_pool=True):
        super().__init__()
        def c(v):
            return max(8, int(v * scale))
        self.stem = ConvBNLayer(3, c(32), 3, stride=2, padding=1)
        cfg = [(32, 64, 1), (64, 128, 2), (128, 128, 1), (128, 256, 2),
               (256, 256, 1), (256, 512, 2)] + [(512, 512, 1)] * 5 + \
              [(512, 1024, 2), (1024, 1024, 1)]
        self.blocks = Sequential(*[
            _DepthwiseSeparable(c(i), c(o), s) for i, o, s in cfg])
        self.with_pool = with_pool
        self.pool = AdaptiveAvgPool2D(1)
        self.fc = Linear(c(1024), num_classes) if num_classes > 0 else None

    def forward(self, x):
        x = self.blocks(self.stem(x))
        if self.with_pool:
            x = self.pool(x)
        if self.fc is not None:
            x = self.fc(x.flatten(1))
        return x


def mobilenet_v1(pretrained=False, scale=1.0, **kw):
    return MobileNetV1(scale=scale, **kw)


# ---- MobileNetV3 (mobilenetv3.py) -------------------------------------------
class _SqueezeExcite(Layer):
    def __init__(self, c, r=4):
        super().__init__()
        mid = _make_divisible(c // r)
        self.pool = AdaptiveAvgPool2D(1)
        self.fc1 = Conv2D(c, mid, 1)
        self.fc2 = Conv2D(mid, c, 1)

    def forward(self, x):
        s = F.relu(self.fc1(self.pool(x)))
        s = F.hardsigmoid(self.fc2(s))
        return x * s


class _MBV3Block(Layer):
    def __init__(self, cin, exp, cout, k, stride, use_se, act):
        super().__init__()
        self.use_res = stride == 1 and cin == cout
        layers = []
        if exp != cin:
            layers.append(ConvBNLayer(cin, exp, 1, act=act))
        layers.append(ConvBNLayer(exp, exp, k, stride=stride,
                                  padding=k // 2, groups=exp, act=act))
        if use_se:
            layers.append(_SqueezeExcite(exp))
        layers.append(ConvBNLayer(exp, cout, 1, act=None))
        self.block = Sequential(*layers)

    def forward(self, x):
        y = self.block(x)
        return x + y if self.use_res else y


# (k, exp, out, SE, act, stride) per published config
_V3_LARGE = [
    (3, 16, 16, False, "relu", 1), (3, 64, 24, False, "relu", 2),
    (3, 72, 24, False, "relu", 1), (5, 72, 40, True, "relu", 2),
    (5, 120, 40, True, "relu", 1), (5, 120, 40, True, "relu", 1),
    (3, 240, 80, False, "hardswish", 2), (3, 200, 80, False, "hardswish", 1),
    (3, 184, 80, False, "hardswish", 1), (3, 184, 80, False, "hardswish", 1),
    (3, 480, 112, True, "hardswish", 1), (3, 672, 112, True, "hardswish", 1),
    (5, 672, 160, True, "hardswish", 2), (5, 960, 160, True, "hardswish", 1),
    (5, 960, 160, True, "hardswish", 1)]
_V3_SMALL = [
    (3, 16, 16, True, "relu", 2), (3, 72, 24, False, "relu", 2),
    (3, 88, 24, False, "relu", 1), (5, 96, 40, True, "hardswish", 2),
    (5, 240, 40, True, "hardswish", 1), (5, 240, 40, True, "hardswish", 1),
    (5, 120, 48, True, "hardswish", 1), (5, 144, 48, True, "hardswish", 1),
    (5, 288, 96, True, "hardswish", 2), (5, 576, 96, True, "hardswish", 1),
    (5, 576, 96, True, "hardswish", 1)]


class MobileNetV3(Layer):
    """reference mobilenetv3.py (small/large)."""

    def __init__(self, config="large", scale=1.0, num_classes=1000,
                 with_pool=True):
        super().__init__()
        cfg = _V3_LARGE if config == "large" else _V3_SMALL
        last_exp = 960 if config == "large" else 576
        last_c = 1280 if config == "large" else 1024

        def c(v):
            return _make_divisible(v * scale)
        self.stem = ConvBNLayer(3, c(16), 3, stride=2, padding=1,
                                act="hardswish")
        blocks, cin = [], c(16)
        for k, exp, cout, se, act, s in cfg:
            blocks.append(_MBV3Block(cin, c(exp), c(cout), k, s, se, act))
            cin = c(cout)
        self.blocks = Sequential(*blocks)
        self.conv_last = ConvBNLayer(cin, c(last_exp), 1, act="hardswish")
        self.with_pool = with_pool
        self.pool = AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.classifier = Sequential(
                Linear(c(last_exp), last_c), Hardswish(), Dropout(0.2),
                Linear(last_c, num_classes))
        else:
            self.classifier = None

    def forward(self, x):
        x = self.conv_last(self.blocks(self.stem(x)))
        if self.with_pool:
            x = self.pool(x)
        if self.classifier is not None:
            x = self.classifier(x.flatten(1))
        return x


def mobilenet_v3_large(pretrained=False, scale=1.0, **kw):
    return MobileNetV3("large", scale=scale, **kw)


def mobilenet_v3_small(pretrained=False, scale=1.0, **kw):
    return MobileNetV3("small", scale=scale, **kw)


# ---- GoogLeNet / Inception v1 (googlenet.py) --------------------------------
class _Inception(Layer):
    def __init__(self, cin, c1, c3r, c3, c5r, c5, proj):
        super().__init__()
        self.b1 = ConvBNLayer(cin, c1, 1)
        self.b2 = Sequential(ConvBNLayer(cin, c3r, 1),
                             ConvBNLayer(c3r, c3, 3, padding=1))
        self.b3 = Sequential(ConvBNLayer(cin, c5r, 1),
                             ConvBNLayer(c5r, c5, 3, padding=1))
        self.b4 = Sequential(MaxPool2D(3, stride=1, padding=1),
                             ConvBNLayer(cin, proj, 1))

    def forward(self, x):
        return ops.concat([self.b1(x), self.b2(x), self.b3(x), self.b4(x)],
                          axis=1)


class _AuxHead(Layer):
    def __init__(self, cin, num_classes):
        super().__init__()
        self.pool = AdaptiveAvgPool2D(4)
        self.conv = ConvBNLayer(cin, 128, 1)
        self.fc1 = Linear(128 * 16, 1024)
        self.drop = Dropout(0.7)
        self.fc2 = Linear(1024, num_classes)

    def forward(self, x):
        x = self.conv(self.pool(x)).flatten(1)
        x = self.drop(F.relu(self.fc1(x)))
        return self.fc2(x)


class GoogLeNet(Layer):
    """reference googlenet.py — returns (main, aux1, aux2) like the
    reference (aux heads train-time only in typical recipes)."""

    def __init__(self, num_classes=1000, with_pool=True):
        super().__init__()
        self.stem = Sequential(
            ConvBNLayer(3, 64, 7, stride=2, padding=3),
            MaxPool2D(3, stride=2, padding=1),
            ConvBNLayer(64, 64, 1),
            ConvBNLayer(64, 192, 3, padding=1),
            MaxPool2D(3, stride=2, padding=1))
        self.i3a = _Inception(192, 64, 96, 128, 16, 32, 32)
        self.i3b = _Inception(256, 128, 128, 192, 32, 96, 64)
        self.pool3 = MaxPool2D(3, stride=2, padding=1)
        self.i4a = _Inception(480, 192, 96, 208, 16, 48, 64)
        self.i4b = _Inception(512, 160, 112, 224, 24, 64, 64)
        self.i4c = _Inception(512, 128, 128, 256, 24, 64, 64)
        self.i4d = _Inception(512, 112, 144, 288, 32, 64, 64)
        self.i4e = _Inception(528, 256, 160, 320, 32, 128, 128)
        self.pool4 = MaxPool2D(3, stride=2, padding=1)
        self.i5a = _Inception(832, 256, 160, 320, 32, 128, 128)
        self.i5b = _Inception(832, 384, 192, 384, 48, 128, 128)
        self.aux1 = _AuxHead(512, num_classes)
        self.aux2 = _AuxHead(528, num_classes)
        self.with_pool = with_pool
        self.pool = AdaptiveAvgPool2D(1)
        self.drop = Dropout(0.4)
        self.fc = Linear(1024, num_classes)

    def forward(self, x):
        x = self.pool3(self.i3b(self.i3a(self.stem(x))))
        x = self.i4a(x)
        a1 = self.aux1(x) if self.training else None
        x = self.i4d(self.i4c(self.i4b(x)))
        a2 = self.aux2(x) if self.training else None
        x = self.i5b(self.i5a(self.pool4(self.i4e(x))))
        if self.with_pool:
            x = self.pool(x)
        out = self.fc(self.drop(x.flatten(1)))
        if self.training:
            return out, a1, a2
        return out


def googlenet(pretrained=False, **kw):
    return GoogLeNet(**kw)


# ---- InceptionV3 (inceptionv3.py) -------------------------------------------
class _IncA(Layer):
    def __init__(self, cin, pool_feat):
        super().__init__()
        self.b1 = ConvBNLayer(cin, 64, 1)
        self.b5 = Sequential(ConvBNLayer(cin, 48, 1),
                             ConvBNLayer(48, 64, 5, padding=2))
        self.b3 = Sequential(ConvBNLayer(cin, 64, 1),
                             ConvBNLayer(64, 96, 3, padding=1),
                             ConvBNLayer(96, 96, 3, padding=1))
        self.bp = Sequential(AvgPool2D(3, stride=1, padding=1),
                             ConvBNLayer(cin, pool_feat, 1))

    def forward(self, x):
        return ops.concat([self.b1(x), self.b5(x), self.b3(x), self.bp(x)],
                          axis=1)


class _RedA(Layer):
    def __init__(self, cin):
        super().__init__()
        self.b3 = ConvBNLayer(cin, 384, 3, stride=2)
        self.b3d = Sequential(ConvBNLayer(cin, 64, 1),
                              ConvBNLayer(64, 96, 3, padding=1),
                              ConvBNLayer(96, 96, 3, stride=2))
        self.pool = MaxPool2D(3, stride=2)

    def forward(self, x):
        return ops.concat([self.b3(x), self.b3d(x), self.pool(x)], axis=1)


class _IncB(Layer):
    def __init__(self, cin, c7):
        super().__init__()
        self.b1 = ConvBNLayer(cin, 192, 1)
        self.b7 = Sequential(
            ConvBNLayer(cin, c7, 1),
            ConvBNLayer(c7, c7, (1, 7), padding=(0, 3)),
            ConvBNLayer(c7, 192, (7, 1), padding=(3, 0)))
        self.b7d = Sequential(
            ConvBNLayer(cin, c7, 1),
            ConvBNLayer(c7, c7, (7, 1), padding=(3, 0)),
            ConvBNLayer(c7, c7, (1, 7), padding=(0, 3)),
            ConvBNLayer(c7, c7, (7, 1), padding=(3, 0)),
            ConvBNLayer(c7, 192, (1, 7), padding=(0, 3)))
        self.bp = Sequential(AvgPool2D(3, stride=1, padding=1),
                             ConvBNLayer(cin, 192, 1))

    def forward(self, x):
        return ops.concat([self.b1(x), self.b7(x), self.b7d(x), self.bp(x)],
                          axis=1)


class _RedB(Layer):
    def __init__(self, cin):
        super().__init__()
        self.b3 = Sequential(ConvBNLayer(cin, 192, 1),
                             ConvBNLayer(192, 320, 3, stride=2))
        self.b7 = Sequential(
            ConvBNLayer(cin, 192, 1),
            ConvBNLayer(192, 192, (1, 7), padding=(0, 3)),
            ConvBNLayer(192, 192, (7, 1), padding=(3, 0)),
            ConvBNLayer(192, 192, 3, stride=2))
        self.pool = MaxPool2D(3, stride=2)

    def forward(self, x):
        return ops.concat([self.b3(x), self.b7(x), self.pool(x)], axis=1)


class _IncC(Layer):
    def __init__(self, cin):
        super().__init__()
        self.b1 = ConvBNLayer(cin, 320, 1)
        self.b3r = ConvBNLayer(cin, 384, 1)
        self.b3a = ConvBNLayer(384, 384, (1, 3), padding=(0, 1))
        self.b3b = ConvBNLayer(384, 384, (3, 1), padding=(1, 0))
        self.bdr = Sequential(ConvBNLayer(cin, 448, 1),
                              ConvBNLayer(448, 384, 3, padding=1))
        self.bda = ConvBNLayer(384, 384, (1, 3), padding=(0, 1))
        self.bdb = ConvBNLayer(384, 384, (3, 1), padding=(1, 0))
        self.bp = Sequential(AvgPool2D(3, stride=1, padding=1),
                             ConvBNLayer(cin, 192, 1))

    def forward(self, x):
        b3 = self.b3r(x)
        bd = self.bdr(x)
        return ops.concat(
            [self.b1(x), self.b3a(b3), self.b3b(b3),
             self.bda(bd), self.bdb(bd), self.bp(x)], axis=1)


class InceptionV3(Layer):
    """reference inceptionv3.py. The auxiliary classifier is NOT implemented
    (canonical aux-free variant; param count 23,834,568 @ 1000 classes) —
    training recipes that rely on the aux loss need to add their own head."""

    def __init__(self, num_classes=1000, with_pool=True):
        super().__init__()
        self.stem = Sequential(
            ConvBNLayer(3, 32, 3, stride=2),
            ConvBNLayer(32, 32, 3),
            ConvBNLayer(32, 64, 3, padding=1),
            MaxPool2D(3, stride=2),
            ConvBNLayer(64, 80, 1),
            ConvBNLayer(80, 192, 3),
            MaxPool2D(3, stride=2))
        self.blocks = Sequential(
            _IncA(192, 32), _IncA(256, 64), _IncA(288, 64),
            _RedA(288),
            _IncB(768, 128), _IncB(768, 160), _IncB(768, 160), _IncB(768, 192),
            _RedB(768),
            _IncC(1280), _IncC(2048))
        self.with_pool = with_pool
        self.pool = AdaptiveAvgPool2D(1)
        self.drop = Dropout(0.5)
        self.fc = Linear(2048, num_classes) if num_classes > 0 else None

    def forward(self, x):
        x = self.blocks(self.stem(x))
        if self.with_pool:
            x = self.pool(x)
        if self.fc is not None:
            x = self.fc(self.drop(x.flatten(1)))
        return x


def inception_v3(pretrained=False, **kw):
    return InceptionV3(**kw)
