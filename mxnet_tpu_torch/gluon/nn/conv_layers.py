"""Gluon convolution and pooling layers (counterpart of
``mxnet_tpu/gluon/nn/conv_layers.py``). Channel-first layouts only."""
from __future__ import annotations

from ..._dispatch import amp_cast
from ...base import MXNetError
from ...ops import nn as _nn
from ...ops import tensor as _tensor
from ..block import HybridBlock
from ..parameter import DeferredParams

__all__ = ["Conv1D", "Conv2D", "Conv3D", "Conv1DTranspose", "Conv2DTranspose",
           "Conv3DTranspose", "MaxPool1D", "MaxPool2D", "MaxPool3D",
           "AvgPool1D", "AvgPool2D", "AvgPool3D", "GlobalMaxPool1D",
           "GlobalMaxPool2D", "GlobalMaxPool3D", "GlobalAvgPool1D",
           "GlobalAvgPool2D", "GlobalAvgPool3D", "ReflectionPad2D"]


def _tuple(val, n):
    if isinstance(val, (list, tuple)):
        if len(val) != n:
            raise MXNetError(f"expected length-{n} tuple, got {val}")
        return tuple(val)
    return (val,) * n


class _Conv(DeferredParams, HybridBlock):
    """Shared convolution machinery (ref: conv_layers.py _Conv): the
    Convolution op with weight ``(channels, in/groups, *k)``, or the
    Deconvolution op (``transpose``) with weight ``(in, channels/groups,
    *k)``; then the optional activation."""

    def __init__(self, channels, kernel_size, strides, padding, dilation,
                 groups, layout, in_channels=0, activation=None,
                 use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", adj=None):
        super().__init__()
        ndim = len(kernel_size)
        if layout not in ("NCW", "NCHW", "NCDHW"):
            raise MXNetError(f"only channel-first layouts are supported, got "
                             f"{layout!r}")
        self._channels = channels
        self._in_channels = in_channels
        self._groups = groups
        self._transpose = adj is not None
        self._activation = activation
        self._use_bias = use_bias
        self._kwargs = {"kernel": kernel_size,
                        "stride": _tuple(strides, ndim),
                        "dilate": _tuple(dilation, ndim),
                        "pad": _tuple(padding, ndim), "num_filter": channels,
                        "num_group": groups, "no_bias": not use_bias}
        if self._transpose:
            self._kwargs["adj"] = _tuple(adj, ndim)
        self._declare("weight", self._weight_shape(in_channels),
                      weight_initializer)
        if use_bias:
            self._declare("bias", (channels,), bias_initializer)

    def _weight_shape(self, in_channels):
        kernel = self._kwargs["kernel"]
        if self._transpose:
            return (in_channels, self._channels // self._groups) + kernel
        return (self._channels, in_channels // self._groups
                if in_channels else 0) + kernel

    def infer_shape(self, x):
        self._set_shape("weight", self._weight_shape(x.shape[1]))
        self._in_channels = x.shape[1]

    def forward(self, x):
        op = _nn.deconvolution if self._transpose else _nn.convolution
        x, w, b = amp_cast(
            "Deconvolution" if self._transpose else "Convolution", x,
            self.weight, self.bias if self._use_bias else None)
        out = op(x, w, b, **self._kwargs)
        if self._activation is not None:
            out, = amp_cast("Activation", out, act_type=self._activation)
            out = _nn.activation(out, act_type=self._activation)
        return out

    def extra_repr(self):
        return (f"{self._in_channels} -> {self._channels}, "
                f"kernel_size={self._kwargs['kernel']}, "
                f"stride={self._kwargs['stride']}")


class Conv1D(_Conv):
    def __init__(self, channels, kernel_size, strides=1, padding=0,
                 dilation=1, groups=1, layout="NCW", activation=None,
                 use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0):
        super().__init__(channels, _tuple(kernel_size, 1), strides, padding,
                         dilation, groups, layout, in_channels, activation,
                         use_bias, weight_initializer, bias_initializer)


class Conv2D(_Conv):
    """2-D convolution, NCHW/OIHW (ref: nn.Conv2D → Convolution op)."""

    def __init__(self, channels, kernel_size, strides=(1, 1), padding=(0, 0),
                 dilation=(1, 1), groups=1, layout="NCHW", activation=None,
                 use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0):
        super().__init__(channels, _tuple(kernel_size, 2), strides, padding,
                         dilation, groups, layout, in_channels, activation,
                         use_bias, weight_initializer, bias_initializer)


class Conv3D(_Conv):
    def __init__(self, channels, kernel_size, strides=(1, 1, 1),
                 padding=(0, 0, 0), dilation=(1, 1, 1), groups=1,
                 layout="NCDHW", activation=None, use_bias=True,
                 weight_initializer=None, bias_initializer="zeros",
                 in_channels=0):
        super().__init__(channels, _tuple(kernel_size, 3), strides, padding,
                         dilation, groups, layout, in_channels, activation,
                         use_bias, weight_initializer, bias_initializer)


class Conv1DTranspose(_Conv):
    def __init__(self, channels, kernel_size, strides=1, padding=0,
                 output_padding=0, dilation=1, groups=1, layout="NCW",
                 activation=None, use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0):
        super().__init__(channels, _tuple(kernel_size, 1), strides, padding,
                         dilation, groups, layout, in_channels, activation,
                         use_bias, weight_initializer, bias_initializer,
                         adj=_tuple(output_padding, 1))


class Conv2DTranspose(_Conv):
    """ref: nn.Conv2DTranspose → Deconvolution op, ``output_padding``
    its ``adj``."""

    def __init__(self, channels, kernel_size, strides=(1, 1), padding=(0, 0),
                 output_padding=(0, 0), dilation=(1, 1), groups=1,
                 layout="NCHW", activation=None, use_bias=True,
                 weight_initializer=None, bias_initializer="zeros",
                 in_channels=0):
        super().__init__(channels, _tuple(kernel_size, 2), strides, padding,
                         dilation, groups, layout, in_channels, activation,
                         use_bias, weight_initializer, bias_initializer,
                         adj=_tuple(output_padding, 2))


class Conv3DTranspose(_Conv):
    def __init__(self, channels, kernel_size, strides=(1, 1, 1),
                 padding=(0, 0, 0), output_padding=(0, 0, 0),
                 dilation=(1, 1, 1), groups=1, layout="NCDHW",
                 activation=None, use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0):
        super().__init__(channels, _tuple(kernel_size, 3), strides, padding,
                         dilation, groups, layout, in_channels, activation,
                         use_bias, weight_initializer, bias_initializer,
                         adj=_tuple(output_padding, 3))


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
        x, = amp_cast("Pooling", x, **self._kwargs)
        return _nn.pooling(x, **self._kwargs)

    def extra_repr(self):
        return (f"size={self._kwargs['kernel']}, "
                f"stride={self._kwargs['stride']}, "
                f"padding={self._kwargs['pad']}")


class MaxPool1D(_Pooling):
    def __init__(self, pool_size=2, strides=None, padding=0, layout="NCW",
                 ceil_mode=False):
        super().__init__(_tuple(pool_size, 1), strides, padding, ceil_mode,
                         False, "max")


class MaxPool2D(_Pooling):
    def __init__(self, pool_size=(2, 2), strides=None, padding=0,
                 layout="NCHW", ceil_mode=False):
        super().__init__(_tuple(pool_size, 2), strides, padding, ceil_mode,
                         False, "max")


class MaxPool3D(_Pooling):
    def __init__(self, pool_size=(2, 2, 2), strides=None, padding=0,
                 layout="NCDHW", ceil_mode=False):
        super().__init__(_tuple(pool_size, 3), strides, padding, ceil_mode,
                         False, "max")


class AvgPool1D(_Pooling):
    def __init__(self, pool_size=2, strides=None, padding=0, layout="NCW",
                 ceil_mode=False, count_include_pad=True):
        super().__init__(_tuple(pool_size, 1), strides, padding, ceil_mode,
                         False, "avg", count_include_pad)


class AvgPool2D(_Pooling):
    def __init__(self, pool_size=(2, 2), strides=None, padding=0,
                 layout="NCHW", ceil_mode=False, count_include_pad=True):
        super().__init__(_tuple(pool_size, 2), strides, padding, ceil_mode,
                         False, "avg", count_include_pad)


class AvgPool3D(_Pooling):
    def __init__(self, pool_size=(2, 2, 2), strides=None, padding=0,
                 layout="NCDHW", ceil_mode=False, count_include_pad=True):
        super().__init__(_tuple(pool_size, 3), strides, padding, ceil_mode,
                         False, "avg", count_include_pad)


class GlobalMaxPool1D(_Pooling):
    def __init__(self, layout="NCW"):
        super().__init__((1,), None, 0, True, True, "max")


class GlobalMaxPool2D(_Pooling):
    def __init__(self, layout="NCHW"):
        super().__init__((1, 1), None, 0, True, True, "max")


class GlobalMaxPool3D(_Pooling):
    def __init__(self, layout="NCDHW"):
        super().__init__((1, 1, 1), None, 0, True, True, "max")


class GlobalAvgPool1D(_Pooling):
    def __init__(self, layout="NCW"):
        super().__init__((1,), None, 0, True, True, "avg")


class GlobalAvgPool2D(_Pooling):
    def __init__(self, layout="NCHW"):
        super().__init__((1, 1), None, 0, True, True, "avg")


class GlobalAvgPool3D(_Pooling):
    def __init__(self, layout="NCDHW"):
        super().__init__((1, 1, 1), None, 0, True, True, "avg")


class ReflectionPad2D(HybridBlock):
    """ref: nn.ReflectionPad2D → the pad op in reflect mode; an int pads
    H and W on both sides, a tuple is the op's flat ``pad_width``."""

    def __init__(self, padding=0):
        super().__init__()
        if isinstance(padding, int):
            padding = (0, 0, 0, 0, padding, padding, padding, padding)
        self._padding = tuple(padding)

    def forward(self, x):
        x, = amp_cast("pad", x, mode="reflect")
        return _tensor.pad(x, mode="reflect", pad_width=self._padding)

    def extra_repr(self):
        return f"padding={self._padding}"
