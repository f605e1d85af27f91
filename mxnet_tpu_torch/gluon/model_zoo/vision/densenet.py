"""DenseNet 121/161/169/201 (counterpart of
``mxnet_tpu/gluon/model_zoo/vision/densenet.py``; ref:
python/mxnet/gluon/model_zoo/vision/densenet.py). Each dense layer's
output is concatenated to its input on channels."""
from __future__ import annotations

from ....base import MXNetError
from ....ops import tensor as _tensor
from ...block import HybridBlock
from ... import nn
from .resnet import PRETRAINED

__all__ = ["DenseNet", "densenet121", "densenet161", "densenet169",
           "densenet201"]


class _DenseLayer(HybridBlock):
    """BN-relu-conv1x1 then BN-relu-conv3x3, concatenated with the
    input."""

    def __init__(self, growth_rate, bn_size, dropout):
        super().__init__()
        self.body = nn.HybridSequential()
        self.body.add(nn.BatchNorm())
        self.body.add(nn.Activation("relu"))
        self.body.add(nn.Conv2D(bn_size * growth_rate, kernel_size=1,
                                use_bias=False))
        self.body.add(nn.BatchNorm())
        self.body.add(nn.Activation("relu"))
        self.body.add(nn.Conv2D(growth_rate, kernel_size=3, padding=1,
                                use_bias=False))
        if dropout:
            self.body.add(nn.Dropout(dropout))

    def forward(self, x):
        return _tensor.concat(x, self.body(x), dim=1)


def _make_dense_block(num_layers, bn_size, growth_rate, dropout):
    out = nn.HybridSequential()
    for _ in range(num_layers):
        out.add(_DenseLayer(growth_rate, bn_size, dropout))
    return out


def _make_transition(num_output_features):
    out = nn.HybridSequential()
    out.add(nn.BatchNorm())
    out.add(nn.Activation("relu"))
    out.add(nn.Conv2D(num_output_features, kernel_size=1, use_bias=False))
    out.add(nn.AvgPool2D(pool_size=2, strides=2))
    return out


class DenseNet(HybridBlock):
    """ref: densenet.py DenseNet — any ``num_init_features``,
    ``growth_rate`` and ``block_config`` (narrow ones too)."""

    def __init__(self, num_init_features, growth_rate, block_config,
                 bn_size=4, dropout=0, classes=1000):
        super().__init__()
        self.features = nn.HybridSequential()
        self.features.add(nn.Conv2D(num_init_features, kernel_size=7,
                                    strides=2, padding=3, use_bias=False))
        self.features.add(nn.BatchNorm())
        self.features.add(nn.Activation("relu"))
        self.features.add(nn.MaxPool2D(pool_size=3, strides=2, padding=1))
        num_features = num_init_features
        for i, num_layers in enumerate(block_config):
            self.features.add(_make_dense_block(num_layers, bn_size,
                                                growth_rate, dropout))
            num_features = num_features + num_layers * growth_rate
            if i != len(block_config) - 1:
                num_features = num_features // 2
                self.features.add(_make_transition(num_features))
        self.features.add(nn.BatchNorm())
        self.features.add(nn.Activation("relu"))
        self.features.add(nn.AvgPool2D(pool_size=7))
        self.features.add(nn.Flatten())
        self.output = nn.Dense(classes)

    def forward(self, x):
        return self.output(self.features(x))


# num_init_features, growth_rate, block_config (ref: densenet.py
# densenet_spec)
densenet_spec = {121: (64, 32, [6, 12, 24, 16]),
                 161: (96, 48, [6, 12, 36, 24]),
                 169: (64, 32, [6, 12, 32, 32]),
                 201: (64, 32, [6, 12, 48, 32])}


def get_densenet(num_layers, pretrained=False, ctx=None, root=None,
                 **kwargs):
    """ref: densenet.py get_densenet."""
    if pretrained:
        raise MXNetError(PRETRAINED)
    num_init_features, growth_rate, block_config = densenet_spec[num_layers]
    return DenseNet(num_init_features, growth_rate, block_config, **kwargs)


def densenet121(**kwargs):
    return get_densenet(121, **kwargs)


def densenet161(**kwargs):
    return get_densenet(161, **kwargs)


def densenet169(**kwargs):
    return get_densenet(169, **kwargs)


def densenet201(**kwargs):
    return get_densenet(201, **kwargs)
