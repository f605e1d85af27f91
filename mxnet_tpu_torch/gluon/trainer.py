"""Gluon Trainer (counterpart of ``mxnet_tpu/gluon/trainer.py``, ref
``python/mxnet/gluon/trainer.py``), for one device.

``Trainer(net.collect_params(), "adam", {"learning_rate": 1e-4})`` takes
the tensors of the dict that require grad (``collect_params()`` also
lists buffers, such as BatchNorm's running statistics, which are not
trained). ``step(batch_size)`` sets ``rescale_grad = scale / batch_size``
and applies the optimizer to every weight with its ``.grad``, in place.
A weight that no backward reached is updated with a zero gradient, as the
reference's zero-filled gradient buffer gives. There is no KVStore: on
one device ``allreduce_grads`` has nothing to do.
"""
from __future__ import annotations

import torch

from .. import optimizer as opt
from ..base import MXNetError

__all__ = ["Trainer"]


class Trainer:
    """ref: gluon.Trainer — ``step(batch_size)`` = allreduce (nothing on
    one device) + update."""

    def __init__(self, params, optimizer, optimizer_params=None):
        if hasattr(params, "values"):
            params = list(params.values())
        if not isinstance(params, (list, tuple)):
            raise MXNetError("Trainer expects a dict of parameters (e.g. "
                             "collect_params()) or a list of tensors")
        for p in params:
            if not isinstance(p, torch.Tensor):
                raise MXNetError(f"invalid parameter {p!r}")
        self._params = [p for p in params if p.requires_grad]
        optimizer_params = dict(optimizer_params or {})
        self._scale = float(optimizer_params.get("rescale_grad", 1.0))
        if isinstance(optimizer, opt.Optimizer):
            if set(optimizer_params) - {"rescale_grad"}:
                raise MXNetError("optimizer_params must be None when "
                                 "optimizer is an Optimizer instance")
            self._optimizer = optimizer
        else:
            self._optimizer = opt.create(optimizer, **optimizer_params)
        self._updater = opt.get_updater(self._optimizer)

    @property
    def learning_rate(self):
        return self._optimizer.learning_rate

    @property
    def optimizer(self):
        return self._optimizer

    def set_learning_rate(self, lr):
        self._optimizer.set_learning_rate(lr)

    def step(self, batch_size):
        """Rescale by ``1 / batch_size`` and update (ref: Trainer.step)."""
        self.allreduce_grads()
        self.update(batch_size)

    def allreduce_grads(self):
        """Nothing to reduce on one device (ref: Trainer.allreduce_grads)."""

    def update(self, batch_size):
        """The update half of ``step`` (ref: Trainer.update)."""
        self._optimizer.rescale_grad = self._scale / batch_size
        for i, weight in enumerate(self._params):
            grad = weight.grad
            if grad is None:
                grad = torch.zeros_like(weight)
            self._updater(i, grad, weight)
