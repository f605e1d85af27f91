"""Optimizer classes (counterpart of ``mxnet_tpu/optimizer/optimizer.py``,
ref ``python/mxnet/optimizer/optimizer.py``).

An :class:`Optimizer` holds the hyperparameters and a per-index update
count, creates each weight's state and calls the fused updates of
:mod:`mxnet_tpu_torch.ops.optimizer_op`, which write weight and state in
place. An :class:`Updater` keeps the states keyed by weight index.
"""
from __future__ import annotations

import math

import torch

from ..base import MXNetError
from ..ops import optimizer_op as _op

__all__ = ["Adam", "Optimizer", "SGD", "Updater", "create", "get_updater",
           "register"]

_REGISTRY = {}


def register(klass):
    """Register an Optimizer subclass under its lower-case name."""
    _REGISTRY[klass.__name__.lower()] = klass
    return klass


def create(name, **kwargs):
    """An :class:`Optimizer` from an instance or a registered name."""
    if isinstance(name, Optimizer):
        return name
    key = str(name).lower()
    if key not in _REGISTRY:
        raise MXNetError(f"unknown optimizer {name!r}; known: "
                         f"{sorted(_REGISTRY)}")
    return _REGISTRY[key](**kwargs)


class Optimizer:
    """ref: optimizer.py Optimizer — lr, wd, ``rescale_grad``,
    ``clip_gradient`` and per-index update counts."""

    def __init__(self, rescale_grad=1.0, wd=0.0, clip_gradient=None,
                 learning_rate=0.01):
        self.rescale_grad = rescale_grad
        self.lr = learning_rate
        self.wd = wd
        self.clip_gradient = clip_gradient
        self.num_update = 0
        self._index_update_count = {}

    def create_state(self, index, weight):
        return None

    def _update_count(self, index):
        count = self._index_update_count.get(index, 0) + 1
        self._index_update_count[index] = count
        self.num_update = max(count, self.num_update)

    def set_learning_rate(self, lr):
        self.lr = lr

    @property
    def learning_rate(self):
        return self.lr

    def _get_wd(self, index):
        """The wd of weight ``index`` (ref: Optimizer._get_wd; no wd
        multipliers yet)."""
        return self.wd

    def _common(self):
        return dict(lr=self.lr, wd=self.wd, rescale_grad=self.rescale_grad,
                    clip_gradient=self.clip_gradient
                    if self.clip_gradient is not None else -1.0)

    def update(self, index, weight, grad, state):
        raise NotImplementedError


@register
class SGD(Optimizer):
    """SGD with optional momentum (ref: optimizer.py SGD →
    sgd_update / sgd_mom_update)."""

    def __init__(self, momentum=0.0, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum

    def create_state(self, index, weight):
        if self.momentum != 0.0:
            return torch.zeros_like(weight)
        return None

    def update(self, index, weight, grad, state):
        self._update_count(index)
        kw = self._common()
        if state is None:
            _op.sgd_update(weight, grad, **kw)
        else:
            _op.sgd_mom_update(weight, grad, state, momentum=self.momentum,
                               **kw)


@register
class Adam(Optimizer):
    """Adam with the bias correction folded into the learning rate,
    ``lr * sqrt(1 - beta2^t) / (1 - beta1^t)`` (ref: optimizer.py Adam)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon

    def create_state(self, index, weight):
        return torch.zeros_like(weight), torch.zeros_like(weight)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        kw = self._common()
        t = self._index_update_count[index]
        kw["lr"] *= math.sqrt(1.0 - self.beta2 ** t) / (1.0 - self.beta1
                                                        ** t)
        mean, var = state
        _op.adam_update(weight, grad, mean, var, beta1=self.beta1,
                        beta2=self.beta2, epsilon=self.epsilon, **kw)


class Updater:
    """The states of one optimizer keyed by weight index (ref:
    optimizer.py Updater)."""

    def __init__(self, optimizer):
        self.optimizer = optimizer
        self.states = {}

    def __call__(self, index, grad, weight):
        if index not in self.states:
            self.states[index] = self.optimizer.create_state(index, weight)
        self.optimizer.update(index, weight, grad, self.states[index])


def get_updater(optimizer):
    return Updater(optimizer)
