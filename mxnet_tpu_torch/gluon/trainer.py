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

With fp16 AMP (``contrib.amp.init("float16")`` and ``amp.init_trainer``)
``step`` checks every gradient with one fused reduction and one host
read: a non-finite step skips the update, leaving weights and optimizer
state untouched, and halves the loss scale. bf16 has fp32's exponent
range, so no check runs.
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
        self._skipped_steps = 0

    @property
    def learning_rate(self):
        return self._optimizer.learning_rate

    @property
    def optimizer(self):
        return self._optimizer

    def set_learning_rate(self, lr):
        self._optimizer.set_learning_rate(lr)

    @property
    def skipped_steps(self):
        """Steps skipped on a non-finite gradient so far."""
        return self._skipped_steps

    def _active_scaler(self):
        """The fp16 loss scaler, or None: bf16 cannot overflow where fp32
        does not, so its steps are not checked."""
        scaler = getattr(self, "_amp_loss_scaler", None)
        if scaler is not None:
            from ..contrib.amp import amp_dtype
            if amp_dtype() != "float16":
                scaler = None
        return scaler

    def step(self, batch_size, ignore_stale_grad=False, loss=None):
        """Rescale by ``1 / batch_size`` and update (ref: Trainer.step).
        With an fp16 loss scaler, one fused finiteness check over the
        gradients (and ``loss``'s mean, when given) and one host read
        decide the step: on overflow the update is skipped and the scale
        halved. A weight no backward reached is updated with a zero
        gradient either way (``ignore_stale_grad`` changes nothing)."""
        self.allreduce_grads()
        scaler = self._active_scaler()
        if scaler is not None:
            from ..guardrails import fused
            grads = [p.grad for p in self._params if p.grad is not None]
            mean = None if loss is None else torch.mean(loss.float())
            finite, _ = fused.guard_stats(grads, mean)
            if not fused.host_fetch(finite)[0]:
                self._skipped_steps += 1
                scaler.update_scale(True)
                return
        self.update(batch_size)
        if scaler is not None:
            scaler.update_scale(False)

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
