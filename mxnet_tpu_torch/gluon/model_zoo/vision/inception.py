"""Inception V3 (counterpart of
``mxnet_tpu/gluon/model_zoo/vision/inception.py``; ref:
python/mxnet/gluon/model_zoo/vision/inception.py), 299x299 inputs:
parallel branches concatenated on channels, BatchNorm eps 1e-3, the
branch average pools counting their padding."""
from __future__ import annotations

from ....base import MXNetError
from ....ops import tensor as _tensor
from ...block import HybridBlock
from ... import nn
from .resnet import PRETRAINED

__all__ = ["Inception3", "inception_v3"]

_SETTING_NAMES = ("channels", "kernel_size", "strides", "padding")


def _conv_kwargs(setting):
    return {name: value for name, value in zip(_SETTING_NAMES, setting)
            if value is not None}


def _make_basic_conv(**kwargs):
    out = nn.HybridSequential()
    out.add(nn.Conv2D(use_bias=False, **kwargs))
    out.add(nn.BatchNorm(epsilon=0.001))
    out.add(nn.Activation("relu"))
    return out


def _make_branch(use_pool, *conv_settings):
    out = nn.HybridSequential()
    if use_pool == "avg":
        out.add(nn.AvgPool2D(pool_size=3, strides=1, padding=1))
    elif use_pool == "max":
        out.add(nn.MaxPool2D(pool_size=3, strides=2))
    for setting in conv_settings:
        out.add(_make_basic_conv(**_conv_kwargs(setting)))
    return out


class _Concurrent(HybridBlock):
    """Parallel branches (children "0", "1", ...) concatenated on
    channels (ref: inception.py _Concurrent)."""

    def __init__(self, branches):
        super().__init__()
        for i, branch in enumerate(branches):
            self.add_module(str(i), branch)

    def forward(self, x):
        return _tensor.concat(*[child(x) for child in self.children()],
                              dim=1)


def _make_A(pool_features):
    return _Concurrent([
        _make_branch(None, (64, 1, None, None)),
        _make_branch(None, (48, 1, None, None), (64, 5, None, 2)),
        _make_branch(None, (64, 1, None, None), (96, 3, None, 1),
                     (96, 3, None, 1)),
        _make_branch("avg", (pool_features, 1, None, None)),
    ])


def _make_B():
    return _Concurrent([
        _make_branch(None, (384, 3, 2, None)),
        _make_branch(None, (64, 1, None, None), (96, 3, None, 1),
                     (96, 3, 2, None)),
        _make_branch("max"),
    ])


def _make_C(channels_7x7):
    return _Concurrent([
        _make_branch(None, (192, 1, None, None)),
        _make_branch(None, (channels_7x7, 1, None, None),
                     (channels_7x7, (1, 7), None, (0, 3)),
                     (192, (7, 1), None, (3, 0))),
        _make_branch(None, (channels_7x7, 1, None, None),
                     (channels_7x7, (7, 1), None, (3, 0)),
                     (channels_7x7, (1, 7), None, (0, 3)),
                     (channels_7x7, (7, 1), None, (3, 0)),
                     (192, (1, 7), None, (0, 3))),
        _make_branch("avg", (192, 1, None, None)),
    ])


def _make_D():
    return _Concurrent([
        _make_branch(None, (192, 1, None, None), (320, 3, 2, None)),
        _make_branch(None, (192, 1, None, None), (192, (1, 7), None, (0, 3)),
                     (192, (7, 1), None, (3, 0)), (192, 3, 2, None)),
        _make_branch("max"),
    ])


class _ExpandedBranch(HybridBlock):
    """A 1x1 stem, then (1x3, 3x1) in parallel, concatenated (block E)."""

    def __init__(self, first_settings):
        super().__init__()
        self.stem = nn.HybridSequential()
        for setting in first_settings:
            self.stem.add(_make_basic_conv(**_conv_kwargs(setting)))
        self.p1 = _make_basic_conv(channels=384, kernel_size=(1, 3),
                                   padding=(0, 1))
        self.p2 = _make_basic_conv(channels=384, kernel_size=(3, 1),
                                   padding=(1, 0))

    def forward(self, x):
        x = self.stem(x)
        return _tensor.concat(self.p1(x), self.p2(x), dim=1)


def _make_E():
    return _Concurrent([
        _make_branch(None, (320, 1, None, None)),
        _ExpandedBranch([(384, 1, None, None)]),
        _ExpandedBranch([(448, 1, None, None), (384, 3, None, 1)]),
        _make_branch("avg", (192, 1, None, None)),
    ])


class Inception3(HybridBlock):
    """ref: inception.py Inception3 (input 299x299)."""

    def __init__(self, classes=1000):
        super().__init__()
        self.features = nn.HybridSequential()
        self.features.add(_make_basic_conv(channels=32, kernel_size=3,
                                           strides=2))
        self.features.add(_make_basic_conv(channels=32, kernel_size=3))
        self.features.add(_make_basic_conv(channels=64, kernel_size=3,
                                           padding=1))
        self.features.add(nn.MaxPool2D(pool_size=3, strides=2))
        self.features.add(_make_basic_conv(channels=80, kernel_size=1))
        self.features.add(_make_basic_conv(channels=192, kernel_size=3))
        self.features.add(nn.MaxPool2D(pool_size=3, strides=2))
        self.features.add(_make_A(32))
        self.features.add(_make_A(64))
        self.features.add(_make_A(64))
        self.features.add(_make_B())
        self.features.add(_make_C(128))
        self.features.add(_make_C(160))
        self.features.add(_make_C(160))
        self.features.add(_make_C(192))
        self.features.add(_make_D())
        self.features.add(_make_E())
        self.features.add(_make_E())
        self.features.add(nn.AvgPool2D(pool_size=8))
        self.features.add(nn.Dropout(0.5))
        self.output = nn.Dense(classes)

    def forward(self, x):
        return self.output(self.features(x))


def inception_v3(pretrained=False, ctx=None, root=None, **kwargs):
    """ref: inception.py inception_v3."""
    if pretrained:
        raise MXNetError(PRETRAINED)
    return Inception3(**kwargs)
