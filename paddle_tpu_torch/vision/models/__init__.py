"""Vision model zoo (reference: python/paddle/vision/models) — LeNet + ResNet
family (the conv-heavy benchmark path, BASELINE config #4)."""
from __future__ import annotations

from ...nn.layer.layers import Layer
from ...nn.layer.common import Linear, Flatten, Dropout
from ...nn.layer.conv import Conv2D
from ...nn.layer.norm import BatchNorm2D
from ...nn.layer.pooling import MaxPool2D, AdaptiveAvgPool2D
from ...nn.layer.activation import ReLU
from ...nn.layer.container import Sequential
from ... import nn


class LeNet(Layer):
    def __init__(self, num_classes=10):
        super().__init__()
        self.features = Sequential(
            Conv2D(1, 6, 3, stride=1, padding=1), ReLU(), MaxPool2D(2, 2),
            Conv2D(6, 16, 5, stride=1), ReLU(), MaxPool2D(2, 2))
        self.fc = Sequential(Linear(400, 120), Linear(120, 84),
                             Linear(84, num_classes))

    def forward(self, x):
        x = self.features(x)
        x = x.flatten(1)
        return self.fc(x)


class BasicBlock(Layer):
    expansion = 1

    def __init__(self, inplanes, planes, stride=1, downsample=None):
        super().__init__()
        self.conv1 = Conv2D(inplanes, planes, 3, stride=stride, padding=1,
                            bias_attr=False)
        self.bn1 = BatchNorm2D(planes)
        self.relu = ReLU()
        self.conv2 = Conv2D(planes, planes, 3, padding=1, bias_attr=False)
        self.bn2 = BatchNorm2D(planes)
        self.downsample = downsample
        self.stride = stride

    def forward(self, x):
        identity = x
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        if self.downsample is not None:
            identity = self.downsample(x)
        return self.relu(out + identity)


class BottleneckBlock(Layer):
    expansion = 4

    def __init__(self, inplanes, planes, stride=1, downsample=None, groups=1,
                 base_width=64):
        super().__init__()
        width = int(planes * (base_width / 64.0)) * groups
        self.conv1 = Conv2D(inplanes, width, 1, bias_attr=False)
        self.bn1 = BatchNorm2D(width)
        self.conv2 = Conv2D(width, width, 3, stride=stride, padding=1,
                            groups=groups, bias_attr=False)
        self.bn2 = BatchNorm2D(width)
        self.conv3 = Conv2D(width, planes * 4, 1, bias_attr=False)
        self.bn3 = BatchNorm2D(planes * 4)
        self.relu = ReLU()
        self.downsample = downsample

    def forward(self, x):
        identity = x
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        if self.downsample is not None:
            identity = self.downsample(x)
        return self.relu(out + identity)


class ResNet(Layer):
    """groups/width follow the torchvision convention: ResNeXt sets
    (groups=32, width=4), wide ResNet sets width=128 (reference resnet.py
    resnext50_32x4d / wide_resnet50_2 factories)."""

    def __init__(self, block, depth=50, width=64, num_classes=1000,
                 with_pool=True, groups=1):
        super().__init__()
        layer_cfg = {18: [2, 2, 2, 2], 34: [3, 4, 6, 3], 50: [3, 4, 6, 3],
                     101: [3, 4, 23, 3], 152: [3, 8, 36, 3]}
        layers = layer_cfg[depth]
        if block is BasicBlock and (groups != 1 or width != 64):
            raise ValueError(
                "BasicBlock only supports groups=1 and width=64 "
                "(ResNeXt/wide variants need the bottleneck block)")
        self.groups = groups
        self.base_width = width
        self.inplanes = 64
        self.conv1 = Conv2D(3, 64, 7, stride=2, padding=3, bias_attr=False)
        self.bn1 = BatchNorm2D(64)
        self.relu = ReLU()
        self.maxpool = MaxPool2D(3, stride=2, padding=1)
        self.layer1 = self._make_layer(block, 64, layers[0])
        self.layer2 = self._make_layer(block, 128, layers[1], stride=2)
        self.layer3 = self._make_layer(block, 256, layers[2], stride=2)
        self.layer4 = self._make_layer(block, 512, layers[3], stride=2)
        self.avgpool = AdaptiveAvgPool2D((1, 1))
        self.fc = Linear(512 * block.expansion, num_classes)

    def _make_layer(self, block, planes, blocks, stride=1):
        downsample = None
        if stride != 1 or self.inplanes != planes * block.expansion:
            downsample = Sequential(
                Conv2D(self.inplanes, planes * block.expansion, 1, stride=stride,
                       bias_attr=False),
                BatchNorm2D(planes * block.expansion))
        kw = {}
        if block is BottleneckBlock and (self.groups > 1 or
                                         self.base_width != 64):
            kw = {"groups": self.groups, "base_width": self.base_width}
        layers = [block(self.inplanes, planes, stride, downsample, **kw)]
        self.inplanes = planes * block.expansion
        for _ in range(1, blocks):
            layers.append(block(self.inplanes, planes, **kw))
        return Sequential(*layers)

    def forward(self, x):
        x = self.maxpool(self.relu(self.bn1(self.conv1(x))))
        x = self.layer4(self.layer3(self.layer2(self.layer1(x))))
        x = self.avgpool(x).flatten(1)
        return self.fc(x)


def resnet18(pretrained=False, **kwargs):
    return ResNet(BasicBlock, 18, **kwargs)


def resnet34(pretrained=False, **kwargs):
    return ResNet(BasicBlock, 34, **kwargs)


def resnet50(pretrained=False, **kwargs):
    return ResNet(BottleneckBlock, 50, **kwargs)


def resnet101(pretrained=False, **kwargs):
    return ResNet(BottleneckBlock, 101, **kwargs)


def resnet152(pretrained=False, **kwargs):
    return ResNet(BottleneckBlock, 152, **kwargs)


def resnext50_32x4d(pretrained=False, **kwargs):
    return ResNet(BottleneckBlock, 50, width=4, groups=32, **kwargs)


def resnext101_32x4d(pretrained=False, **kwargs):
    return ResNet(BottleneckBlock, 101, width=4, groups=32, **kwargs)


def resnext101_64x4d(pretrained=False, **kwargs):
    return ResNet(BottleneckBlock, 101, width=4, groups=64, **kwargs)


def wide_resnet50_2(pretrained=False, **kwargs):
    return ResNet(BottleneckBlock, 50, width=128, **kwargs)


def wide_resnet101_2(pretrained=False, **kwargs):
    return ResNet(BottleneckBlock, 101, width=128, **kwargs)


from .extra import (VGG, vgg16, vgg19, MobileNetV2, mobilenet_v2,
                    AlexNet, alexnet)  # noqa: F401,E402
from .extra2 import (DenseNet, densenet121, densenet161, densenet169,  # noqa: F401,E402
                     densenet201, SqueezeNet, squeezenet1_0, squeezenet1_1,
                     ShuffleNetV2, shufflenet_v2_x0_25, shufflenet_v2_x0_5,
                     shufflenet_v2_x1_0, shufflenet_v2_x1_5,
                     shufflenet_v2_x2_0, shufflenet_v2_swish,
                     MobileNetV1, mobilenet_v1, MobileNetV3,
                     mobilenet_v3_large, mobilenet_v3_small,
                     GoogLeNet, googlenet, InceptionV3, inception_v3)
