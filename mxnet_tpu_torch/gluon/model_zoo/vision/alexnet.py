"""AlexNet (counterpart of ``mxnet_tpu/gluon/model_zoo/vision/alexnet.py``;
ref: python/mxnet/gluon/model_zoo/vision/alexnet.py). Its two
``Dense(4096, activation="relu")`` take the matmul-epilogue kernel on the
card, as in VGG."""
from __future__ import annotations

from ...block import HybridBlock
from ... import nn
from .resnet import PRETRAINED
from ....base import MXNetError

__all__ = ["AlexNet", "alexnet"]


class AlexNet(HybridBlock):
    """ref: alexnet.py AlexNet."""

    def __init__(self, classes=1000):
        super().__init__()
        self.features = nn.HybridSequential()
        self.features.add(nn.Conv2D(64, kernel_size=11, strides=4,
                                    padding=2, activation="relu"))
        self.features.add(nn.MaxPool2D(pool_size=3, strides=2))
        self.features.add(nn.Conv2D(192, kernel_size=5, padding=2,
                                    activation="relu"))
        self.features.add(nn.MaxPool2D(pool_size=3, strides=2))
        self.features.add(nn.Conv2D(384, kernel_size=3, padding=1,
                                    activation="relu"))
        self.features.add(nn.Conv2D(256, kernel_size=3, padding=1,
                                    activation="relu"))
        self.features.add(nn.Conv2D(256, kernel_size=3, padding=1,
                                    activation="relu"))
        self.features.add(nn.MaxPool2D(pool_size=3, strides=2))
        self.features.add(nn.Flatten())
        self.features.add(nn.Dense(4096, activation="relu"))
        self.features.add(nn.Dropout(0.5))
        self.features.add(nn.Dense(4096, activation="relu"))
        self.features.add(nn.Dropout(0.5))
        self.output = nn.Dense(classes)

    def forward(self, x):
        return self.output(self.features(x))


def alexnet(pretrained=False, ctx=None, root=None, **kwargs):
    """ref: alexnet.py alexnet."""
    if pretrained:
        raise MXNetError(PRETRAINED)
    return AlexNet(**kwargs)
