"""Gluon convolution and pooling layers (counterpart of
``mxnet_tpu/gluon/nn/conv_layers.py``). Channel-first layouts only."""
from __future__ import annotations

from ...base import MXNetError
from ...ops import nn as _nn
from ..block import HybridBlock
from ..parameter import DeferredParams

__all__ = ["Conv2D", "MaxPool2D", "AvgPool2D", "GlobalAvgPool2D"]


def _tuple(val, n):
    if isinstance(val, (list, tuple)):
        if len(val) != n:
            raise MXNetError(f"expected length-{n} tuple, got {val}")
        return tuple(val)
    return (val,) * n


class Conv2D(DeferredParams, HybridBlock):
    """2-D convolution, NCHW/OIHW (ref: nn.Conv2D → Convolution op)."""

    def __init__(self, channels, kernel_size, strides=(1, 1), padding=(0, 0),
                 dilation=(1, 1), groups=1, layout="NCHW", activation=None,
                 use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0):
        super().__init__()
        if layout != "NCHW":
            raise MXNetError(f"only the NCHW layout is supported, got "
                             f"{layout!r}")
        kernel = _tuple(kernel_size, 2)
        self._channels = channels
        self._groups = groups
        self._activation = activation
        self._use_bias = use_bias
        self._kwargs = {"kernel": kernel, "stride": _tuple(strides, 2),
                        "dilate": _tuple(dilation, 2),
                        "pad": _tuple(padding, 2), "num_filter": channels,
                        "num_group": groups, "no_bias": not use_bias}
        self._declare("weight", (channels, in_channels // groups
                                 if in_channels else 0) + kernel,
                      weight_initializer)
        if use_bias:
            self._declare("bias", (channels,), bias_initializer)

    def infer_shape(self, x):
        self._set_shape("weight", (self._channels, x.shape[1] // self._groups)
                        + self._kwargs["kernel"])

    def forward(self, x):
        out = _nn.convolution(x, self.weight,
                              self.bias if self._use_bias else None,
                              **self._kwargs)
        if self._activation is not None:
            out = _nn.activation(out, act_type=self._activation)
        return out

    def extra_repr(self):
        return (f"channels={self._channels}, "
                f"kernel_size={self._kwargs['kernel']}, "
                f"stride={self._kwargs['stride']}")


class _Pooling(HybridBlock):
    """Shared pooling machinery (ref: conv_layers.py _Pooling)."""

    def __init__(self, pool_size, strides, padding, ceil_mode, global_pool,
                 pool_type, count_include_pad=True):
        super().__init__()
        if strides is None:
            strides = pool_size
        self._kwargs = {
            "kernel": pool_size,
            "stride": _tuple(strides, len(pool_size)),
            "pad": _tuple(padding, len(pool_size)),
            "global_pool": global_pool,
            "pool_type": pool_type,
            "pooling_convention": "full" if ceil_mode else "valid",
            "count_include_pad": count_include_pad,
        }

    def forward(self, x):
        return _nn.pooling(x, **self._kwargs)

    def extra_repr(self):
        return (f"size={self._kwargs['kernel']}, "
                f"stride={self._kwargs['stride']}, "
                f"padding={self._kwargs['pad']}")


class MaxPool2D(_Pooling):
    def __init__(self, pool_size=(2, 2), strides=None, padding=0,
                 layout="NCHW", ceil_mode=False):
        super().__init__(_tuple(pool_size, 2), strides, padding, ceil_mode,
                         False, "max")


class AvgPool2D(_Pooling):
    def __init__(self, pool_size=(2, 2), strides=None, padding=0,
                 layout="NCHW", ceil_mode=False, count_include_pad=True):
        super().__init__(_tuple(pool_size, 2), strides, padding, ceil_mode,
                         False, "avg", count_include_pad)


class GlobalAvgPool2D(_Pooling):
    def __init__(self, layout="NCHW"):
        super().__init__((1, 1), None, 0, True, True, "avg")
