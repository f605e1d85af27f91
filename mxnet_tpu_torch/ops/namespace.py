"""The operator namespace that ``HybridLambda`` passes as ``F`` and in
which ``Lambda`` and ``HybridLambda`` resolve a function given by name:
the port's operator functions under their MXNet names (``F.reshape``,
``F.concat``, ``F.Activation``, ``F.LeakyReLU``, ``F.slice_axis``, ...).

The JAX package passes its ``mx.nd`` module there. The port's ``mx.nd``
holds the ``.params`` container only until ROADMAP Queue 1 item 6 (NDArray
and the operator registry) replaces this module; a name that is not here
raises :class:`MXNetError` naming that item."""
from __future__ import annotations

import torch

from ..base import MXNetError
from . import nn as _nn
from . import tensor as _tensor

__all__ = ["Activation", "BatchNorm", "Concat", "Convolution",
           "Deconvolution", "Dropout", "Embedding", "Flatten",
           "FullyConnected", "GroupNorm", "InstanceNorm", "LayerNorm",
           "LeakyReLU", "Pad", "Pooling", "Reshape", "SwapAxis", "abs",
           "broadcast_add", "broadcast_div", "broadcast_like",
           "broadcast_mul", "broadcast_sub", "concat", "exp",
           "expand_dims", "flatten", "log", "log_softmax", "mean", "pad",
           "relu", "reshape", "reshape_like", "sigmoid", "slice_axis",
           "softmax", "sqrt", "square", "squeeze", "stack", "sum",
           "swapaxes", "tanh"]

Activation = _nn.activation
BatchNorm = _nn.batch_norm
Convolution = _nn.convolution
Deconvolution = _nn.deconvolution
Dropout = _nn.dropout
Embedding = _nn.embedding
FullyConnected = _nn.fully_connected
GroupNorm = _nn.group_norm
InstanceNorm = _nn.instance_norm
LayerNorm = _nn.layer_norm
LeakyReLU = _nn.leaky_relu
Pooling = _nn.pooling
Concat = concat = _tensor.concat
Flatten = flatten = _tensor.flatten
Pad = pad = _tensor.pad
Reshape = reshape = _tensor.reshape
SwapAxis = swapaxes = _tensor.swapaxes
broadcast_like = _tensor.broadcast_like
expand_dims = _tensor.expand_dims
log_softmax = _tensor.log_softmax
reshape_like = _tensor.reshape_like
slice_axis = _tensor.slice_axis
squeeze = _tensor.squeeze
stack = _tensor.stack
abs = torch.abs                       # noqa: A001 - MXNet's name
exp = torch.exp
log = torch.log
relu = torch.relu
sigmoid = torch.sigmoid
sqrt = torch.sqrt
square = torch.square
tanh = torch.tanh
broadcast_add = torch.add
broadcast_div = torch.div
broadcast_mul = torch.mul
broadcast_sub = torch.sub


def softmax(x, axis=-1):
    """ref: softmax."""
    return torch.softmax(x, dim=axis)


def sum(x, axis=None, keepdims=False):  # noqa: A001 - MXNet's name
    """ref: sum — over ``axis`` (an int or a tuple), or every axis."""
    return torch.sum(x) if axis is None else torch.sum(x, dim=axis,
                                                       keepdim=keepdims)


def mean(x, axis=None, keepdims=False):
    """ref: mean — over ``axis`` (an int or a tuple), or every axis."""
    return torch.mean(x) if axis is None else torch.mean(x, dim=axis,
                                                         keepdim=keepdims)


def __getattr__(name):
    raise MXNetError(f"the operator {name!r} is not in the port's operator "
                     "namespace yet: NDArray and the operator registry are "
                     "ROADMAP Queue 1 item 6")
