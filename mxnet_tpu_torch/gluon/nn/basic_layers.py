"""Gluon basic layers (counterpart of
``mxnet_tpu/gluon/nn/basic_layers.py``).

Each layer is a thin Block over one operator function of
:mod:`mxnet_tpu_torch.ops`; parameter names match the JAX package's.
Each op call passes its inputs through ``amp_cast`` under the op's
registry name, as the JAX layer's ``F.<op>`` call goes through the
registry's dispatch (the per-op policy of ``amp.init`` with op lists).
"""
from __future__ import annotations

import math

import torch

from ... import autograd as _autograd
from ... import initializer as _initializer
from ..._dispatch import amp_cast
from ...base import MXNetError
from ...ops import contrib as _contrib
from ...ops import nn as _nn
from ...ops import tensor as _tensor
from ..block import Block, HybridBlock
from ..parameter import DeferredParams

__all__ = ["Sequential", "HybridSequential", "Dense", "Dropout", "BatchNorm",
           "LayerNorm", "GroupNorm", "InstanceNorm", "Embedding", "Flatten",
           "Lambda", "HybridLambda", "Activation", "LeakyReLU", "PReLU",
           "ELU", "SELU", "GELU", "Swish", "SyncBatchNorm"]


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


# activations Dense fuses into the matmul-epilogue kernel (K2): one
# bias + activation (+ dropout) pass over the matmul output. gelu is
# epilogue-only (the Activation op has no gelu mode).
_EPILOGUE_ACTS = ("relu", "tanh", "sigmoid", "gelu")


class Dense(DeferredParams, HybridBlock):
    """y = act(x W^T + b) (ref: nn.Dense → FullyConnected op).

    With a bias and an activation in relu/tanh/sigmoid/gelu, or with a
    bias, no activation and ``epilogue_dropout > 0``, the layer runs the
    matrix product without its bias and then the matmul-epilogue kernel
    (K2) over its output, exactly where the JAX package fuses. Any other
    layer is the plain FullyConnected (+ activation, + Dropout) path.
    ``epilogue_dropout`` is an inverted dropout that acts only in
    training."""

    def __init__(self, units, activation=None, use_bias=True, flatten=True,
                 dtype="float32", weight_initializer=None,
                 bias_initializer="zeros", in_units=0, epilogue_dropout=0.0):
        super().__init__()
        self._units = units
        self._flatten = flatten
        self._activation = activation
        self._use_bias = use_bias
        self._epilogue_dropout = float(epilogue_dropout)
        self._fuse = use_bias and (
            activation in _EPILOGUE_ACTS
            or (activation is None and self._epilogue_dropout > 0))
        self._declare("weight", (units, in_units), weight_initializer, dtype)
        if use_bias:
            self._declare("bias", (units,), bias_initializer, dtype)

    def infer_shape(self, x):
        in_units = math.prod(x.shape[1:]) if self._flatten else x.shape[-1]
        self._set_shape("weight", (self._units, in_units))

    def forward(self, x):
        bias = self.bias if self._use_bias else None
        if self._fuse:
            x, w = amp_cast("FullyConnected", x, self.weight)
            out = _nn.fully_connected(x, w, num_hidden=self._units,
                                      no_bias=True, flatten=self._flatten)
            act_type = self._activation or "identity"
            out, bias = amp_cast("_contrib_matmul_epilogue", out, bias,
                                 act_type=act_type)
            return _contrib.matmul_epilogue(
                out, bias, act_type=act_type, p=self._epilogue_dropout,
                training=self.training)
        x, w, bias = amp_cast("FullyConnected", x, self.weight, bias)
        out = _nn.fully_connected(x, w, bias, num_hidden=self._units,
                                  no_bias=bias is None,
                                  flatten=self._flatten)
        if self._activation == "gelu":
            out, = amp_cast("LeakyReLU", out, act_type="gelu")
            out = _nn.leaky_relu(out, act_type="gelu")
        elif self._activation is not None:
            out, = amp_cast("Activation", out, act_type=self._activation)
            out = _nn.activation(out, act_type=self._activation)
        if self._epilogue_dropout > 0:
            out, = amp_cast("Dropout", out)
            out = _nn.dropout(out, p=self._epilogue_dropout,
                              training=self.training)
        return out

    def extra_repr(self):
        return f"units={self._units}, activation={self._activation}"


class Dropout(HybridBlock):
    """Inverted dropout (ref: nn.Dropout): the identity in predict mode;
    in training (e.g. inside ``autograd.record()``) a mask drawn on the
    input's device, see :func:`ops.nn.dropout`."""

    def __init__(self, rate, axes=()):
        super().__init__()
        self._rate = rate
        self._axes = axes

    def forward(self, x):
        if self._rate <= 0:
            return x
        x, = amp_cast("Dropout", x)
        return _nn.dropout(x, p=self._rate, axes=self._axes,
                           training=self.training)

    def extra_repr(self):
        return f"p={self._rate}, axes={self._axes}"


class BatchNorm(DeferredParams, HybridBlock):
    """Batch normalization with running statistics (ref: nn.BatchNorm).

    ``activation`` fuses an activation into the normalize pass: the
    conv-epilogue kernel on the card. The layer adds no parameters for
    it, so checkpoints are interchangeable with a BatchNorm + Activation
    pair. In training (``autograd.record()``, unless
    ``use_global_stats``) it normalizes with the batch statistics and
    folds them into the running ones in place, as the JAX layer does:
    ``running·m + batch·(1 − m)``, except that statistics still at
    their init (mean all 0 and var all 1, per layer) adopt the first
    batch's outright, keeping the init var where the batch's var was
    destroyed by cancellation (``mean² > 4096 · var``). The test and the
    selection stay on the device: no host sync per layer."""

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
        training = self.training
        x, gamma, beta, rmean, rvar = amp_cast(
            "BatchNorm", x, self.gamma, self.beta, self.running_mean,
            self.running_var, act_type=self._activation)
        out, mean, var = _nn.batch_norm(
            x, gamma, beta, rmean, rvar,
            eps=self._epsilon, momentum=self._momentum,
            fix_gamma=not self._scale, axis=self._axis,
            use_global_stats=self._use_global_stats,
            act_type=self._activation, training=training)
        if training and not self._use_global_stats:
            # the fold's shift, the running mean, is read by the batch's
            # moments: under remat the fold waits for the recompute
            _autograd.aux_update(self._update_running, mean, var)
        return out

    @torch.no_grad()
    def _update_running(self, mean, var):
        """ref: the JAX layer's functional update, written in place."""
        m = self._momentum
        rmean, rvar = self.running_mean, self.running_var
        cold = torch.logical_and(torch.all(rmean == 0), torch.all(rvar == 1))
        new_mean = torch.where(cold, mean, rmean * m + mean * (1 - m))
        susp_cold = torch.logical_and(cold, torch.square(mean) > 4096.0
                                      * torch.clamp(var.to(mean.dtype),
                                                    min=1e-30))
        new_var = torch.where(susp_cold, rvar,
                              torch.where(cold, var, rvar * m + var * (1 - m)))
        rmean.copy_(new_mean)
        rvar.copy_(new_var)

    def extra_repr(self):
        return (f"axis={self._axis}, eps={self._epsilon}, "
                f"activation={self._activation}")


class SyncBatchNorm(BatchNorm):
    """Cross-device BatchNorm (ref: contrib.nn.SyncBatchNorm). In one
    process it is BatchNorm over axis 1, as in the JAX package."""

    def __init__(self, in_channels=0, num_devices=None, momentum=0.9,
                 epsilon=1e-5, center=True, scale=True, **kwargs):
        super().__init__(axis=1, momentum=momentum, epsilon=epsilon,
                         center=center, scale=scale, in_channels=in_channels,
                         **kwargs)


class _ChannelNorm(DeferredParams, HybridBlock):
    """gamma and beta, one per channel of axis 1 (GroupNorm,
    InstanceNorm)."""

    def __init__(self, epsilon, center, scale, beta_initializer,
                 gamma_initializer, in_channels):
        super().__init__()
        self._epsilon = epsilon
        self._declare("gamma", (in_channels,), gamma_initializer,
                      differentiable=scale)
        self._declare("beta", (in_channels,), beta_initializer,
                      differentiable=center)

    def infer_shape(self, x):
        self._set_shape("gamma", (x.shape[1],))
        self._set_shape("beta", (x.shape[1],))


class GroupNorm(_ChannelNorm):
    """ref: nn.GroupNorm."""

    def __init__(self, num_groups=1, epsilon=1e-5, center=True, scale=True,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels=0):
        super().__init__(epsilon, center, scale, beta_initializer,
                         gamma_initializer, in_channels)
        self._num_groups = num_groups

    def forward(self, x):
        x, gamma, beta = amp_cast("GroupNorm", x, self.gamma, self.beta)
        return _nn.group_norm(x, gamma, beta, num_groups=self._num_groups,
                              eps=self._epsilon)

    def extra_repr(self):
        return f"num_groups={self._num_groups}, eps={self._epsilon}"


class InstanceNorm(_ChannelNorm):
    """ref: nn.InstanceNorm (statistics per sample and channel of axis 1,
    whatever ``axis`` says, as in the JAX package)."""

    def __init__(self, axis=1, epsilon=1e-5, center=True, scale=True,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels=0):
        super().__init__(epsilon, center, scale, beta_initializer,
                         gamma_initializer, in_channels)

    def forward(self, x):
        x, gamma, beta = amp_cast("InstanceNorm", x, self.gamma, self.beta)
        return _nn.instance_norm(x, gamma, beta, eps=self._epsilon)

    def extra_repr(self):
        return f"eps={self._epsilon}"


class LayerNorm(DeferredParams, HybridBlock):
    """ref: nn.LayerNorm — normalize along ``axis`` with two-pass fp32
    moments, then ``* gamma + beta``."""

    def __init__(self, axis=-1, epsilon=1e-5, center=True, scale=True,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels=0):
        super().__init__()
        self._axis = axis
        self._epsilon = epsilon
        self._declare("gamma", (in_channels,), gamma_initializer,
                      differentiable=scale)
        self._declare("beta", (in_channels,), beta_initializer,
                      differentiable=center)

    def infer_shape(self, x):
        channels = x.shape[self._axis]
        self._set_shape("gamma", (channels,))
        self._set_shape("beta", (channels,))

    def forward(self, x):
        x, gamma, beta = amp_cast("LayerNorm", x, self.gamma, self.beta)
        return _nn.layer_norm(x, gamma, beta, axis=self._axis,
                              eps=self._epsilon)

    def extra_repr(self):
        return f"axis={self._axis}, eps={self._epsilon}"


class Embedding(DeferredParams, HybridBlock):
    """Lookup table (ref: nn.Embedding); out-of-range ids give NaN rows,
    as in the JAX package (see :func:`ops.nn.embedding`). With
    ``sparse_grad`` the weight's ``grad_stype`` is "row_sparse" and a
    recorded eager forward gives it a gradient of the touched rows alone
    (``ndarray.sparse.sparse_embedding``), which the Trainer applies
    lazily; a hybridized block keeps a dense gradient."""

    def __init__(self, input_dim, output_dim, dtype="float32",
                 weight_initializer=None, sparse_grad=False):
        super().__init__()
        self._input_dim = input_dim
        self._output_dim = output_dim
        self._sparse_grad = bool(sparse_grad)
        self._declare("weight", (input_dim, output_dim), weight_initializer,
                      dtype, grad_stype="row_sparse" if sparse_grad
                      else "default")

    def forward(self, x):
        x, w = amp_cast("Embedding", x, self.weight,
                        sparse_grad=self._sparse_grad)
        if self._sparse_grad:
            return _nn._sparse_embedding(x, w)
        return _nn.embedding(x, w, input_dim=self._input_dim,
                             output_dim=self._output_dim)

    def extra_repr(self):
        return f"{self._input_dim} -> {self._output_dim}"


def _nd():
    from ... import ndarray
    return ndarray


def _namespace_function(name):
    """The function ``name`` of ``mx.nd``; a name the port has not ported
    yet raises naming its ROADMAP item."""
    try:
        return getattr(_nd(), name)
    except AttributeError:
        raise MXNetError(f"{name!r} is not an operator of mx.nd") from None


class Lambda(Block):
    """Wrap a function as a Block (ref: nn.Lambda). A string names a
    function of ``mx.nd``, as in the JAX package."""

    def __init__(self, function, prefix=None):
        super().__init__()
        if isinstance(function, str):
            self._func = _namespace_function(function)
            self._name = function
        else:
            self._func = function
            self._name = getattr(function, "__name__", "lambda")

    def forward(self, *args):
        return self._func(*args)

    def extra_repr(self):
        return self._name


class HybridLambda(HybridBlock):
    """ref: nn.HybridLambda — ``function(F, x, *args)`` with ``F`` =
    ``mx.nd``, whose operators take the block's tensors and return
    tensors; a string names a function of it."""

    def __init__(self, function, prefix=None):
        super().__init__()
        if isinstance(function, str):
            func = _namespace_function(function)
            self._func = lambda F, *args: func(*args)
            self._name = function
        else:
            self._func = function
            self._name = getattr(function, "__name__", "lambda")

    def forward(self, x, *args):
        return self._func(_nd(), x, *args)

    def extra_repr(self):
        return self._name


class Activation(HybridBlock):
    """ref: nn.Activation."""

    def __init__(self, activation):
        super().__init__()
        self._act_type = activation

    def forward(self, x):
        x, = amp_cast("Activation", x, act_type=self._act_type)
        return _nn.activation(x, act_type=self._act_type)

    def extra_repr(self):
        return self._act_type


class Flatten(HybridBlock):
    """ref: nn.Flatten."""

    def forward(self, x):
        x, = amp_cast("Flatten", x)
        return _tensor.flatten(x)


class LeakyReLU(HybridBlock):
    """ref: nn.LeakyReLU — ``x`` where ``x >= 0``, else ``alpha * x``."""

    def __init__(self, alpha):
        super().__init__()
        self._alpha = alpha

    def forward(self, x):
        x, = amp_cast("LeakyReLU", x, act_type="leaky")
        return _nn.leaky_relu(x, act_type="leaky", slope=self._alpha)

    def extra_repr(self):
        return str(self._alpha)


class PReLU(DeferredParams, HybridBlock):
    """ref: nn.PReLU — a learned slope ``alpha`` per channel of axis 1
    (``in_channels`` of them, 1 by default), Constant(0.25) unless
    ``alpha_initializer`` says otherwise."""

    def __init__(self, alpha_initializer=None, in_channels=1):
        super().__init__()
        if alpha_initializer is None:
            alpha_initializer = _initializer.Constant(0.25)
        self._declare("alpha", (in_channels,), alpha_initializer)

    def forward(self, x):
        x, alpha = amp_cast("LeakyReLU", x, self.alpha, act_type="prelu")
        return _nn.leaky_relu(x, alpha, act_type="prelu")


class ELU(HybridBlock):
    """ref: nn.ELU — ``alpha * (exp(x) - 1)`` below 0."""

    def __init__(self, alpha=1.0):
        super().__init__()
        self._alpha = alpha

    def forward(self, x):
        x, = amp_cast("LeakyReLU", x, act_type="elu")
        return _nn.leaky_relu(x, act_type="elu", slope=self._alpha)


class SELU(HybridBlock):
    """ref: nn.SELU."""

    def forward(self, x):
        x, = amp_cast("LeakyReLU", x, act_type="selu")
        return _nn.leaky_relu(x, act_type="selu")


class GELU(HybridBlock):
    """ref: nn.GELU — exact-erf gelu (the LeakyReLU op's gelu mode)."""

    def forward(self, x):
        x, = amp_cast("LeakyReLU", x, act_type="gelu")
        return _nn.leaky_relu(x, act_type="gelu")


class Swish(HybridBlock):
    """ref: nn.Swish — ``x * sigmoid(beta * x)``."""

    def __init__(self, beta=1.0):
        super().__init__()
        self._beta = beta

    def forward(self, x):
        return x * torch.sigmoid(self._beta * x)
