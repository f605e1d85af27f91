"""Gluon losses (counterpart of ``mxnet_tpu/gluon/loss.py``).

Each loss is a Block whose ``forward(pred, label, sample_weight=None)``
returns one loss per sample: the mean over every axis but
``batch_axis``. Train with ``mx.autograd.backward(L)`` on that vector
(MXNet's per-sample convention; ``Trainer.step(batch_size)`` divides by
the batch)."""
from __future__ import annotations

import torch

from ..base import MXNetError
from ..ops import tensor as _tensor
from .block import HybridBlock

__all__ = ["L2Loss", "Loss", "SoftmaxCELoss", "SoftmaxCrossEntropyLoss"]


def _apply_weighting(loss, weight=None, sample_weight=None):
    """ref: loss.py _apply_weighting."""
    if sample_weight is not None:
        loss = loss * sample_weight
    if weight is not None:
        loss = loss * weight
    return loss


def _reshape_like(x, y):
    return x.reshape(y.shape) if x.shape != y.shape else x


class Loss(HybridBlock):
    """Base loss (ref: gluon/loss.py Loss)."""

    def __init__(self, weight, batch_axis):
        super().__init__()
        self._weight = weight
        self._batch_axis = batch_axis

    def extra_repr(self):
        return f"batch_axis={self._batch_axis}, w={self._weight}"

    def _mean_over_nonbatch(self, loss):
        axes = [a for a in range(loss.ndim) if a != self._batch_axis]
        return torch.mean(loss, dim=axes) if axes else loss


class L2Loss(Loss):
    """``weight / 2 * (pred - label)^2`` (ref: loss.py L2Loss)."""

    def __init__(self, weight=1.0, batch_axis=0):
        super().__init__(weight, batch_axis)

    def forward(self, pred, label, sample_weight=None):
        label = _reshape_like(label, pred)
        loss = torch.square(label - pred)
        loss = _apply_weighting(loss, self._weight / 2, sample_weight)
        return self._mean_over_nonbatch(loss)


class SoftmaxCrossEntropyLoss(Loss):
    """Softmax + cross-entropy (ref: loss.py SoftmaxCrossEntropyLoss).

    With sparse labels and logits (the default) it is the fused ``lse -
    pred[label]``: no log-probability tensor of ``pred``'s shape is made,
    and with ``label_smoothing`` eps the target is ``(1 - eps) *
    pred[label] + eps * mean(pred)``, both in fp32. Otherwise
    ``log_softmax`` (unless ``from_logits``), then ``-pred[label]`` or, for
    dense labels, ``-sum(pred * label)``."""

    def __init__(self, axis=-1, sparse_label=True, from_logits=False,
                 weight=None, batch_axis=0, label_smoothing=0.0):
        super().__init__(weight, batch_axis)
        self._axis = axis
        self._sparse_label = sparse_label
        self._from_logits = from_logits
        self._smoothing = float(label_smoothing)
        if self._smoothing and not sparse_label:
            raise MXNetError("label_smoothing requires sparse_label=True "
                             "(smooth dense label distributions yourself)")

    @property
    def amp_safe(self):
        """True when this loss does its own fp32-accumulated reductions on
        reduced-precision inputs, so ``ShardedTrainer`` may skip the fp32
        cast of the model's outputs: the fused sparse path only (ref: the
        JAX loss's ``amp_safe``)."""
        return self._sparse_label and not self._from_logits

    def forward(self, pred, label, sample_weight=None):
        axis = self._axis
        if self._sparse_label and not self._from_logits:
            lse = _tensor.logsumexp(pred, axis=axis, keepdims=True)
            target = _tensor.pick(pred, label, axis=axis,
                                  keepdims=True).float()
            if self._smoothing:
                eps = self._smoothing
                target = target * (1.0 - eps) + torch.mean(
                    pred.float(), dim=axis, keepdim=True) * eps
            loss = _apply_weighting(lse - target, self._weight,
                                    sample_weight)
            return self._mean_over_nonbatch(loss)
        if not self._from_logits:
            pred = _tensor.log_softmax(pred, axis=axis)
        if self._sparse_label:
            loss = -_tensor.pick(pred, label, axis=axis, keepdims=True)
            if self._smoothing:
                eps = self._smoothing
                loss = loss * (1.0 - eps) - torch.mean(
                    pred, dim=axis, keepdim=True) * eps
        else:
            label = _reshape_like(label, pred)
            loss = -torch.sum(pred * label, dim=axis, keepdim=True)
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return self._mean_over_nonbatch(loss)


SoftmaxCELoss = SoftmaxCrossEntropyLoss
