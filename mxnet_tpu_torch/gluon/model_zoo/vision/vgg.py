"""VGG 11/13/16/19, with and without BatchNorm (counterpart of
``mxnet_tpu/gluon/model_zoo/vision/vgg.py``; ref:
python/mxnet/gluon/model_zoo/vision/vgg.py).

The two ``Dense(4096, activation="relu")`` layers of the classifier take
the matmul-epilogue kernel on the card (bias + relu after the product),
as the JAX package routes them; the output ``Dense`` has no activation
and stays plain."""
from __future__ import annotations

from ...block import HybridBlock
from ... import nn
from .resnet import PRETRAINED
from ....base import MXNetError

__all__ = ["VGG", "vgg11", "vgg13", "vgg16", "vgg19", "vgg11_bn", "vgg13_bn",
           "vgg16_bn", "vgg19_bn", "get_vgg"]

vgg_spec = {11: ([1, 1, 2, 2, 2], [64, 128, 256, 512, 512]),
            13: ([2, 2, 2, 2, 2], [64, 128, 256, 512, 512]),
            16: ([2, 2, 3, 3, 3], [64, 128, 256, 512, 512]),
            19: ([2, 2, 4, 4, 4], [64, 128, 256, 512, 512])}


class VGG(HybridBlock):
    """ref: vgg.py VGG — conv3x3 stages (BatchNorm after each conv with
    ``batch_norm``), a 2x2 max pool after each, two Dense(4096) + relu +
    Dropout(0.5), the output Dense; the classifier's weights draw from
    ``Normal`` (sigma 0.01)."""

    def __init__(self, layers, filters, classes=1000, batch_norm=False):
        super().__init__()
        if len(layers) != len(filters):
            raise MXNetError("VGG needs len(layers) == len(filters)")
        self.features = self._make_features(layers, filters, batch_norm)
        self.features.add(nn.Dense(4096, activation="relu",
                                   weight_initializer="normal"))
        self.features.add(nn.Dropout(0.5))
        self.features.add(nn.Dense(4096, activation="relu",
                                   weight_initializer="normal"))
        self.features.add(nn.Dropout(0.5))
        self.output = nn.Dense(classes, weight_initializer="normal")

    @staticmethod
    def _make_features(layers, filters, batch_norm):
        featurizer = nn.HybridSequential()
        for i, num in enumerate(layers):
            for _ in range(num):
                featurizer.add(nn.Conv2D(filters[i], kernel_size=3,
                                         padding=1))
                if batch_norm:
                    featurizer.add(nn.BatchNorm())
                featurizer.add(nn.Activation("relu"))
            featurizer.add(nn.MaxPool2D(strides=2))
        return featurizer

    def forward(self, x):
        return self.output(self.features(x))


def get_vgg(num_layers, pretrained=False, ctx=None, root=None, **kwargs):
    """ref: vgg.py get_vgg."""
    if pretrained:
        raise MXNetError(PRETRAINED)
    layers, filters = vgg_spec[num_layers]
    return VGG(layers, filters, **kwargs)


def vgg11(**kwargs):
    return get_vgg(11, **kwargs)


def vgg13(**kwargs):
    return get_vgg(13, **kwargs)


def vgg16(**kwargs):
    return get_vgg(16, **kwargs)


def vgg19(**kwargs):
    return get_vgg(19, **kwargs)


def vgg11_bn(**kwargs):
    kwargs["batch_norm"] = True
    return get_vgg(11, **kwargs)


def vgg13_bn(**kwargs):
    kwargs["batch_norm"] = True
    return get_vgg(13, **kwargs)


def vgg16_bn(**kwargs):
    kwargs["batch_norm"] = True
    return get_vgg(16, **kwargs)


def vgg19_bn(**kwargs):
    kwargs["batch_norm"] = True
    return get_vgg(19, **kwargs)
