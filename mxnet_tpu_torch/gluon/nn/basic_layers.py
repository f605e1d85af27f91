"""Gluon basic layers (counterpart of
``mxnet_tpu/gluon/nn/basic_layers.py``).

Each layer is a thin Block over one operator function of
:mod:`mxnet_tpu_torch.ops`; parameter names match the JAX package's.
"""
from __future__ import annotations

import math

import torch.nn.functional as F

from ...base import MXNetError
from ...ops import nn as _nn
from ...ops import tensor as _tensor
from ..block import Block, HybridBlock
from ..parameter import DeferredParams

__all__ = ["Sequential", "HybridSequential", "Dense", "BatchNorm",
           "Activation", "Flatten"]


class Sequential(Block):
    """Stack of Blocks run in order (ref: nn.Sequential). Children are
    named "0", "1", … as in the reference's structural names."""

    def add(self, *blocks):
        for block in blocks:
            self.add_module(str(len(self._modules)), block)

    def forward(self, x):
        for block in self._modules.values():
            x = block(x)
        return x

    def __len__(self):
        return len(self._modules)

    def __getitem__(self, key):
        return list(self._modules.values())[key]

    def __iter__(self):
        return iter(self._modules.values())


class HybridSequential(Sequential, HybridBlock):
    """Stack of HybridBlocks (ref: nn.HybridSequential)."""


# activations the JAX package's Dense fuses into the matmul-epilogue
# kernel (basic_layers.py there); that kernel is not ported yet
_EPILOGUE_ACTS = ("relu", "tanh", "sigmoid", "gelu")


class Dense(DeferredParams, HybridBlock):
    """y = act(x W^T + b) (ref: nn.Dense → FullyConnected op).

    The JAX package runs Dense with a bias and a relu/tanh/sigmoid/gelu
    activation through its matmul-epilogue kernel; that kernel is not
    ported yet, so such a layer raises at construction rather than run
    without it. Without an activation, or without a bias, the layer is
    the plain FullyConnected (+ Activation) path."""

    def __init__(self, units, activation=None, use_bias=True, flatten=True,
                 dtype="float32", weight_initializer=None,
                 bias_initializer="zeros", in_units=0):
        super().__init__()
        if use_bias and activation in _EPILOGUE_ACTS:
            raise MXNetError(
                f"Dense(activation={activation!r}) with a bias runs through "
                "the matmul-epilogue kernel, which is not ported yet")
        self._units = units
        self._flatten = flatten
        self._activation = activation
        self._use_bias = use_bias
        self._declare("weight", (units, in_units), weight_initializer, dtype)
        if use_bias:
            self._declare("bias", (units,), bias_initializer, dtype)

    def infer_shape(self, x):
        in_units = math.prod(x.shape[1:]) if self._flatten else x.shape[-1]
        self._set_shape("weight", (self._units, in_units))

    def forward(self, x):
        out = _nn.fully_connected(
            x, self.weight, self.bias if self._use_bias else None,
            num_hidden=self._units, no_bias=not self._use_bias,
            flatten=self._flatten)
        if self._activation == "gelu":
            return F.gelu(out, approximate="none")
        if self._activation is not None:
            return _nn.activation(out, act_type=self._activation)
        return out

    def extra_repr(self):
        return f"units={self._units}, activation={self._activation}"


class BatchNorm(DeferredParams, HybridBlock):
    """Batch normalization with running statistics (ref: nn.BatchNorm).

    ``activation`` fuses an activation into the normalize pass: the
    conv-epilogue kernel on the card. The layer adds no parameters for
    it, so checkpoints are interchangeable with a BatchNorm + Activation
    pair. Only the inference branch is ported: in training mode the
    layer raises unless ``use_global_stats``."""

    def __init__(self, axis=1, momentum=0.9, epsilon=1e-5, center=True,
                 scale=True, use_global_stats=False,
                 beta_initializer="zeros", gamma_initializer="ones",
                 running_mean_initializer="zeros",
                 running_variance_initializer="ones", in_channels=0,
                 activation=None):
        super().__init__()
        self._axis = axis
        self._momentum = momentum
        self._epsilon = epsilon
        self._scale = scale
        self._use_global_stats = use_global_stats
        self._activation = activation
        self._declare("gamma", (in_channels,), gamma_initializer,
                      differentiable=scale)
        self._declare("beta", (in_channels,), beta_initializer,
                      differentiable=center)
        self._declare("running_mean", (in_channels,),
                      running_mean_initializer, aux=True)
        self._declare("running_var", (in_channels,),
                      running_variance_initializer, aux=True)

    def infer_shape(self, x):
        channels = x.shape[self._axis]
        for name in ("gamma", "beta", "running_mean", "running_var"):
            self._set_shape(name, (channels,))

    def forward(self, x):
        out, _, _ = _nn.batch_norm(
            x, self.gamma, self.beta, self.running_mean, self.running_var,
            eps=self._epsilon, momentum=self._momentum,
            fix_gamma=not self._scale, axis=self._axis,
            use_global_stats=self._use_global_stats,
            act_type=self._activation, training=self.training)
        return out

    def extra_repr(self):
        return (f"axis={self._axis}, eps={self._epsilon}, "
                f"activation={self._activation}")


class Activation(HybridBlock):
    """ref: nn.Activation."""

    def __init__(self, activation):
        super().__init__()
        self._act_type = activation

    def forward(self, x):
        return _nn.activation(x, act_type=self._act_type)

    def extra_repr(self):
        return self._act_type


class Flatten(HybridBlock):
    """ref: nn.Flatten."""

    def forward(self, x):
        return _tensor.flatten(x)
