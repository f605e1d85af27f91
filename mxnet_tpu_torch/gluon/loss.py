"""Gluon losses (counterpart of ``mxnet_tpu/gluon/loss.py``).

Each loss is a Block whose ``forward(pred, label, sample_weight=None)``
returns one loss per sample: the mean over every axis but
``batch_axis``. Train with ``mx.autograd.backward(L)`` on that vector
(MXNet's per-sample convention; ``Trainer.step(batch_size)`` divides by
the batch). The reductions, ``log_softmax``, ``logsumexp`` and ``log``
pass their inputs through ``amp_cast`` under their registry names, where
the JAX losses call ``F.<op>``: the per-op AMP policy's fp32 list keeps
a loss in fp32."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .._dispatch import amp_cast
from ..base import MXNetError
from ..ops import nn as _nn
from ..ops import tensor as _tensor
from .block import HybridBlock

__all__ = ["Loss", "L2Loss", "L1Loss", "SigmoidBinaryCrossEntropyLoss",
           "SigmoidBCELoss", "SoftmaxCrossEntropyLoss", "SoftmaxCELoss",
           "KLDivLoss", "HuberLoss", "HingeLoss", "SquaredHingeLoss",
           "LogisticLoss", "TripletLoss", "CTCLoss", "CosineEmbeddingLoss"]


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
        if not axes:
            return loss
        loss, = amp_cast("mean", loss)
        return torch.mean(loss, dim=axes)


class L2Loss(Loss):
    """``weight / 2 * (pred - label)^2`` (ref: loss.py L2Loss)."""

    def __init__(self, weight=1.0, batch_axis=0):
        super().__init__(weight, batch_axis)

    def forward(self, pred, label, sample_weight=None):
        label = _reshape_like(label, pred)
        loss = torch.square(label - pred)
        loss = _apply_weighting(loss, self._weight / 2, sample_weight)
        return self._mean_over_nonbatch(loss)


class L1Loss(Loss):
    """``|pred - label|`` (ref: loss.py L1Loss)."""

    def __init__(self, weight=None, batch_axis=0):
        super().__init__(weight, batch_axis)

    def forward(self, pred, label, sample_weight=None):
        label = _reshape_like(label, pred)
        loss = _apply_weighting(torch.abs(label - pred), self._weight,
                                sample_weight)
        return self._mean_over_nonbatch(loss)


def _softrelu_neg_abs(pred):
    """``log(1 + exp(-|pred|))``, the stable half of the log-sigmoid."""
    return F.softplus(-torch.abs(pred))


class SigmoidBinaryCrossEntropyLoss(Loss):
    """Binary cross-entropy (ref: loss.py SigmoidBCELoss). On logits
    (the default) in the stable form ``relu(pred) - pred * label +
    log(1 + exp(-|pred|))``, with ``pos_weight`` scaling the positive
    term; with ``from_sigmoid`` on probabilities, ``log(p + 1e-12)``."""

    def __init__(self, from_sigmoid=False, weight=None, batch_axis=0):
        super().__init__(weight, batch_axis)
        self._from_sigmoid = from_sigmoid

    def forward(self, pred, label, sample_weight=None, pos_weight=None):
        label = _reshape_like(label, pred)
        if not self._from_sigmoid:
            if pos_weight is None:
                loss = torch.relu(pred) - pred * label \
                    + _softrelu_neg_abs(pred)
            else:
                log_weight = 1 + (pos_weight - 1) * label
                loss = torch.relu(pred) - pred * label + log_weight * (
                    _softrelu_neg_abs(pred) + torch.relu(-pred))
        else:
            eps = 1e-12
            p_in, = amp_cast("log", pred + eps)
            q_in, = amp_cast("log", 1. - pred + eps)
            if pos_weight is None:
                loss = -(torch.log(p_in) * label
                         + torch.log(q_in) * (1. - label))
            else:
                loss = -(torch.log(p_in) * label * pos_weight
                         + torch.log(q_in) * (1. - label))
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return self._mean_over_nonbatch(loss)


SigmoidBCELoss = SigmoidBinaryCrossEntropyLoss


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
            lse = _tensor.logsumexp(*amp_cast("logsumexp", pred), axis=axis,
                                    keepdims=True)
            target = _tensor.pick(*amp_cast("pick", pred, label), axis=axis,
                                  keepdims=True).float()
            if self._smoothing:
                eps = self._smoothing
                target = target * (1.0 - eps) + torch.mean(
                    *amp_cast("mean", pred.float()), dim=axis,
                    keepdim=True) * eps
            loss = _apply_weighting(lse - target, self._weight,
                                    sample_weight)
            return self._mean_over_nonbatch(loss)
        if not self._from_logits:
            pred = _tensor.log_softmax(*amp_cast("log_softmax", pred),
                                       axis=axis)
        if self._sparse_label:
            loss = -_tensor.pick(*amp_cast("pick", pred, label), axis=axis,
                                 keepdims=True)
            if self._smoothing:
                eps = self._smoothing
                loss = loss * (1.0 - eps) - torch.mean(
                    *amp_cast("mean", pred), dim=axis, keepdim=True) * eps
        else:
            label = _reshape_like(label, pred)
            loss = -torch.sum(*amp_cast("sum", pred * label), dim=axis,
                              keepdim=True)
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return self._mean_over_nonbatch(loss)


SoftmaxCELoss = SoftmaxCrossEntropyLoss


class KLDivLoss(Loss):
    """``label * (log(label + 1e-12) - pred)`` (ref: loss.py KLDivLoss);
    ``pred`` are log-probabilities unless ``from_logits`` is False."""

    def __init__(self, from_logits=True, axis=-1, weight=None, batch_axis=0):
        super().__init__(weight, batch_axis)
        self._from_logits = from_logits
        self._axis = axis

    def forward(self, pred, label, sample_weight=None):
        if not self._from_logits:
            pred = _tensor.log_softmax(*amp_cast("log_softmax", pred),
                                       axis=self._axis)
        loss = label * (torch.log(*amp_cast("log", label + 1e-12)) - pred)
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return self._mean_over_nonbatch(loss)


class HuberLoss(Loss):
    """Smooth L1: quadratic below ``rho``, linear above (ref: loss.py
    HuberLoss)."""

    def __init__(self, rho=1.0, weight=None, batch_axis=0):
        super().__init__(weight, batch_axis)
        self._rho = rho

    def forward(self, pred, label, sample_weight=None):
        label = _reshape_like(label, pred)
        loss = torch.abs(label - pred)
        loss = torch.where(loss > self._rho, loss - 0.5 * self._rho,
                           (0.5 / self._rho) * torch.square(loss))
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return self._mean_over_nonbatch(loss)


class HingeLoss(Loss):
    """``max(0, margin - pred * label)`` (ref: loss.py HingeLoss)."""

    def __init__(self, margin=1, weight=None, batch_axis=0):
        super().__init__(weight, batch_axis)
        self._margin = margin

    def forward(self, pred, label, sample_weight=None):
        label = _reshape_like(label, pred)
        loss = torch.relu(self._margin - pred * label)
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return self._mean_over_nonbatch(loss)


class SquaredHingeLoss(Loss):
    """``max(0, margin - pred * label)^2`` (ref: loss.py
    SquaredHingeLoss)."""

    def __init__(self, margin=1, weight=None, batch_axis=0):
        super().__init__(weight, batch_axis)
        self._margin = margin

    def forward(self, pred, label, sample_weight=None):
        label = _reshape_like(label, pred)
        loss = torch.square(torch.relu(self._margin - pred * label))
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return self._mean_over_nonbatch(loss)


class LogisticLoss(Loss):
    """Logistic loss on logits (ref: loss.py LogisticLoss); labels in
    {-1, 1} (``signed``) or {0, 1} (``binary``)."""

    def __init__(self, weight=None, batch_axis=0, label_format="signed"):
        super().__init__(weight, batch_axis)
        if label_format not in ("signed", "binary"):
            raise MXNetError(f"bad label_format {label_format!r}")
        self._label_format = label_format

    def forward(self, pred, label, sample_weight=None):
        label = _reshape_like(label, pred)
        if self._label_format == "signed":
            label = (label + 1.0) / 2.0
        loss = torch.relu(pred) - pred * label + _softrelu_neg_abs(pred)
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return self._mean_over_nonbatch(loss)


class TripletLoss(Loss):
    """``max(0, |pos - pred|^2 - |neg - pred|^2 + margin)`` summed over
    the non-batch axes (ref: loss.py TripletLoss)."""

    def __init__(self, margin=1, weight=None, batch_axis=0):
        super().__init__(weight, batch_axis)
        self._margin = margin

    def forward(self, pred, positive, negative, sample_weight=None):
        positive = _reshape_like(positive, pred)
        negative = _reshape_like(negative, pred)
        axes = tuple(range(1, pred.ndim))
        loss = torch.sum(*amp_cast("sum", torch.square(positive - pred)
                                   - torch.square(negative - pred)),
                         dim=axes)
        loss = torch.relu(loss + self._margin)
        return _apply_weighting(loss, self._weight, sample_weight)


class CTCLoss(Loss):
    """Connectionist temporal classification (ref: loss.py CTCLoss →
    :func:`ops.nn.ctc_loss`): ``pred`` in the ``layout`` NTC or TNC,
    ``label`` in NT or TN, padded with values < 0 unless
    ``label_lengths`` is given; one -log p per sample."""

    def __init__(self, layout="NTC", label_layout="NT", weight=None):
        if layout not in ("NTC", "TNC"):
            raise MXNetError(f"bad layout {layout!r}")
        super().__init__(weight, 0)
        self._layout = layout
        self._label_layout = label_layout

    def forward(self, pred, label, pred_lengths=None, label_lengths=None,
                sample_weight=None):
        if self._layout == "NTC":
            pred = torch.swapaxes(pred, 0, 1)
        if self._label_layout == "TN":
            label = torch.swapaxes(label, 0, 1)
        loss = _nn.ctc_loss(pred, label, data_lengths=pred_lengths,
                            label_lengths=label_lengths)
        return _apply_weighting(loss, self._weight, sample_weight)


class CosineEmbeddingLoss(Loss):
    """``1 - cos`` for label 1, else ``max(0, cos - margin)`` (ref: loss.py
    CosineEmbeddingLoss)."""

    def __init__(self, weight=None, batch_axis=0, margin=0):
        super().__init__(weight, batch_axis)
        self._margin = margin

    def forward(self, input1, input2, label, sample_weight=None):
        input1 = _reshape_like(input1, input2)
        def norm(x):
            x, = amp_cast("norm", x)
            return torch.sqrt(torch.sum(torch.square(x), dim=-1))

        cos = torch.sum(*amp_cast("sum", input1 * input2), dim=-1) / (
            norm(input1) * norm(input2) + 1e-12)
        label = label.reshape((-1,))
        loss = torch.where(label == 1, 1.0 - cos,
                           torch.relu(cos - self._margin))
        return _apply_weighting(loss, self._weight, sample_weight)
