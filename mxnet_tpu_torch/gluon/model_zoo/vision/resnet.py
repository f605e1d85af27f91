"""ResNet V1 and V2 (counterpart of
``mxnet_tpu/gluon/model_zoo/vision/resnet.py``; ref:
python/mxnet/gluon/model_zoo/vision/resnet.py).

BasicBlock for 18/34 and Bottleneck for 50/101/152, each in the V1
(post-activation, He 2015) and V2 (pre-activation, He 2016)
arrangement, NCHW. In V1 every BatchNorm + relu in a block and every
residual add + relu run as one conv-epilogue pass: the hand-written
CUDA kernel on the card. V2's BatchNorms take no activation and its
residual add is a plain add, as in the JAX package, so it reaches no
kernel.
"""
from __future__ import annotations

from ...._dispatch import amp_cast
from ....base import MXNetError
from ....ops import contrib
from ....ops import nn as _ops_nn
from ...block import HybridBlock
from ... import nn

PRETRAINED = ("pretrained weights are not bundled; use load_parameters() "
              "or convert.load_jax_params()")

__all__ = ["ResNetV1", "ResNetV2", "BasicBlockV1", "BasicBlockV2",
           "BottleneckV1", "BottleneckV2", "resnet18_v1", "resnet34_v1",
           "resnet50_v1", "resnet101_v1", "resnet152_v1", "resnet18_v2",
           "resnet34_v2", "resnet50_v2", "resnet101_v2", "resnet152_v2",
           "get_resnet"]


def _conv3x3(channels, stride, in_channels):
    return nn.Conv2D(channels, kernel_size=3, strides=stride, padding=1,
                     use_bias=False, in_channels=in_channels)


def _downsample(channels, stride, in_channels):
    down = nn.HybridSequential()
    down.add(nn.Conv2D(channels, kernel_size=1, strides=stride,
                       use_bias=False, in_channels=in_channels))
    down.add(nn.BatchNorm())
    return down


class BasicBlockV1(HybridBlock):
    """ref: resnet.py BasicBlockV1 — conv3x3/BN/relu ×2 + identity."""

    def __init__(self, channels, stride, downsample=False, in_channels=0):
        super().__init__()
        self.body = nn.HybridSequential()
        self.body.add(_conv3x3(channels, stride, in_channels))
        self.body.add(nn.BatchNorm(activation="relu"))
        self.body.add(_conv3x3(channels, 1, channels))
        self.body.add(nn.BatchNorm())
        self.downsample = _downsample(channels, stride, in_channels) \
            if downsample else None

    def forward(self, x):
        residual = x
        x = self.body(x)
        if self.downsample is not None:
            residual = self.downsample(residual)
        return contrib.conv_epilogue(
            *amp_cast("_contrib_conv_epilogue", x, residual))


class BottleneckV1(HybridBlock):
    """ref: resnet.py BottleneckV1 — 1x1/3x3/1x1 with 4x expansion, the
    stride on the first 1x1 conv as v1 has it."""

    def __init__(self, channels, stride, downsample=False, in_channels=0):
        super().__init__()
        self.body = nn.HybridSequential()
        self.body.add(nn.Conv2D(channels // 4, kernel_size=1, strides=stride,
                                use_bias=False))
        self.body.add(nn.BatchNorm(activation="relu"))
        self.body.add(_conv3x3(channels // 4, 1, channels // 4))
        self.body.add(nn.BatchNorm(activation="relu"))
        self.body.add(nn.Conv2D(channels, kernel_size=1, strides=1,
                                use_bias=False))
        self.body.add(nn.BatchNorm())
        self.downsample = _downsample(channels, stride, in_channels) \
            if downsample else None

    def forward(self, x):
        residual = x
        x = self.body(x)
        if self.downsample is not None:
            residual = self.downsample(residual)
        return contrib.conv_epilogue(
            *amp_cast("_contrib_conv_epilogue", x, residual))


class BasicBlockV2(HybridBlock):
    """ref: resnet.py BasicBlockV2 — BN/relu before each conv3x3, the
    shortcut a 1x1 conv of the pre-activated input where it downsamples."""

    def __init__(self, channels, stride, downsample=False, in_channels=0):
        super().__init__()
        self.bn1 = nn.BatchNorm()
        self.conv1 = _conv3x3(channels, stride, in_channels)
        self.bn2 = nn.BatchNorm()
        self.conv2 = _conv3x3(channels, 1, channels)
        self.downsample = nn.Conv2D(channels, 1, stride, use_bias=False,
                                    in_channels=in_channels) \
            if downsample else None

    def forward(self, x):
        residual = x
        x = _ops_nn.activation(
            *amp_cast("Activation", self.bn1(x)), act_type="relu")
        if self.downsample is not None:
            residual = self.downsample(x)
        x = self.conv1(x)
        x = _ops_nn.activation(
            *amp_cast("Activation", self.bn2(x)), act_type="relu")
        return self.conv2(x) + residual


class BottleneckV2(HybridBlock):
    """ref: resnet.py BottleneckV2 — pre-activated 1x1/3x3/1x1, the
    stride on the 3x3."""

    def __init__(self, channels, stride, downsample=False, in_channels=0):
        super().__init__()
        self.bn1 = nn.BatchNorm()
        self.conv1 = nn.Conv2D(channels // 4, kernel_size=1, strides=1,
                               use_bias=False)
        self.bn2 = nn.BatchNorm()
        self.conv2 = _conv3x3(channels // 4, stride, channels // 4)
        self.bn3 = nn.BatchNorm()
        self.conv3 = nn.Conv2D(channels, kernel_size=1, strides=1,
                               use_bias=False)
        self.downsample = nn.Conv2D(channels, 1, stride, use_bias=False,
                                    in_channels=in_channels) \
            if downsample else None

    def forward(self, x):
        residual = x
        x = _ops_nn.activation(
            *amp_cast("Activation", self.bn1(x)), act_type="relu")
        if self.downsample is not None:
            residual = self.downsample(x)
        x = self.conv1(x)
        x = _ops_nn.activation(
            *amp_cast("Activation", self.bn2(x)), act_type="relu")
        x = self.conv2(x)
        x = _ops_nn.activation(
            *amp_cast("Activation", self.bn3(x)), act_type="relu")
        return self.conv3(x) + residual


class ResNetV1(HybridBlock):
    """ref: resnet.py ResNetV1."""

    def __init__(self, block, layers, channels, classes=1000,
                 thumbnail=False):
        super().__init__()
        if len(layers) != len(channels) - 1:
            raise MXNetError("ResNetV1 needs len(layers) == "
                             "len(channels) - 1")
        self.features = nn.HybridSequential()
        if thumbnail:
            self.features.add(_conv3x3(channels[0], 1, 0))
        else:
            self.features.add(nn.Conv2D(channels[0], 7, 2, 3,
                                        use_bias=False))
            self.features.add(nn.BatchNorm())
            self.features.add(nn.Activation("relu"))
            self.features.add(nn.MaxPool2D(3, 2, 1))
        for i, num_layer in enumerate(layers):
            stride = 1 if i == 0 else 2
            self.features.add(self._make_layer(
                block, num_layer, channels[i + 1], stride,
                in_channels=channels[i]))
        self.features.add(nn.GlobalAvgPool2D())
        self.output = nn.Dense(classes, in_units=channels[-1])

    @staticmethod
    def _make_layer(block, layers, channels, stride, in_channels=0):
        layer = nn.HybridSequential()
        layer.add(block(channels, stride, channels != in_channels,
                        in_channels=in_channels))
        for _ in range(layers - 1):
            layer.add(block(channels, 1, False, in_channels=channels))
        return layer

    def forward(self, x):
        return self.output(self.features(x))


class ResNetV2(HybridBlock):
    """ref: resnet.py ResNetV2 — a BatchNorm without scale or center on
    the input, pre-activation stages, a final BN/relu before the pool."""

    def __init__(self, block, layers, channels, classes=1000,
                 thumbnail=False):
        super().__init__()
        if len(layers) != len(channels) - 1:
            raise MXNetError("ResNetV2 needs len(layers) == "
                             "len(channels) - 1")
        self.features = nn.HybridSequential()
        self.features.add(nn.BatchNorm(scale=False, center=False))
        if thumbnail:
            self.features.add(_conv3x3(channels[0], 1, 0))
        else:
            self.features.add(nn.Conv2D(channels[0], 7, 2, 3,
                                        use_bias=False))
            self.features.add(nn.BatchNorm())
            self.features.add(nn.Activation("relu"))
            self.features.add(nn.MaxPool2D(3, 2, 1))
        in_channels = channels[0]
        for i, num_layer in enumerate(layers):
            stride = 1 if i == 0 else 2
            self.features.add(ResNetV1._make_layer(
                block, num_layer, channels[i + 1], stride,
                in_channels=in_channels))
            in_channels = channels[i + 1]
        self.features.add(nn.BatchNorm())
        self.features.add(nn.Activation("relu"))
        self.features.add(nn.GlobalAvgPool2D())
        self.features.add(nn.Flatten())
        self.output = nn.Dense(classes, in_units=in_channels)

    def forward(self, x):
        return self.output(self.features(x))


# ref: resnet.py resnet_spec
resnet_spec = {
    18: ("basic_block", [2, 2, 2, 2], [64, 64, 128, 256, 512]),
    34: ("basic_block", [3, 4, 6, 3], [64, 64, 128, 256, 512]),
    50: ("bottle_neck", [3, 4, 6, 3], [64, 256, 512, 1024, 2048]),
    101: ("bottle_neck", [3, 4, 23, 3], [64, 256, 512, 1024, 2048]),
    152: ("bottle_neck", [3, 8, 36, 3], [64, 256, 512, 1024, 2048]),
}
resnet_net_versions = [ResNetV1, ResNetV2]
resnet_block_versions = [
    {"basic_block": BasicBlockV1, "bottle_neck": BottleneckV1},
    {"basic_block": BasicBlockV2, "bottle_neck": BottleneckV2},
]


def get_resnet(version, num_layers, pretrained=False, ctx=None, root=None,
               **kwargs):
    """ref: resnet.py get_resnet."""
    if num_layers not in resnet_spec:
        raise MXNetError(f"invalid resnet depth {num_layers}; "
                         f"options: {sorted(resnet_spec)}")
    if version not in (1, 2):
        raise MXNetError("resnet version must be 1 or 2")
    if pretrained:
        raise MXNetError(PRETRAINED)
    block_type, layers, channels = resnet_spec[num_layers]
    block = resnet_block_versions[version - 1][block_type]
    return resnet_net_versions[version - 1](block, layers, channels,
                                            **kwargs)


def resnet18_v1(**kwargs):
    return get_resnet(1, 18, **kwargs)


def resnet34_v1(**kwargs):
    return get_resnet(1, 34, **kwargs)


def resnet50_v1(**kwargs):
    return get_resnet(1, 50, **kwargs)


def resnet101_v1(**kwargs):
    return get_resnet(1, 101, **kwargs)


def resnet152_v1(**kwargs):
    return get_resnet(1, 152, **kwargs)


def resnet18_v2(**kwargs):
    return get_resnet(2, 18, **kwargs)


def resnet34_v2(**kwargs):
    return get_resnet(2, 34, **kwargs)


def resnet50_v2(**kwargs):
    return get_resnet(2, 50, **kwargs)


def resnet101_v2(**kwargs):
    return get_resnet(2, 101, **kwargs)


def resnet152_v2(**kwargs):
    return get_resnet(2, 152, **kwargs)
