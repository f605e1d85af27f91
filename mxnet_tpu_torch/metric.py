"""Evaluation metrics (counterpart of ``mxnet_tpu/metric.py``; ref:
python/mxnet/metric.py).

The registry and the whole EvalMetric family that training loops consume
(user Gluon loops, ``callback.Speedometer``). An update pulls its inputs
to the host as numpy, as the reference does: on a CUDA tensor it is the
loop's sync point. A torch tensor on any device is accepted; 16-bit
floats arrive as float32, since numpy has no bfloat16 (the JAX package
hands numpy ``ml_dtypes.bfloat16`` arrays, so a metric of 16-bit
predictions may differ from the reference's in its last bits)."""
from __future__ import annotations

import numpy as np
import torch

from .base import MXNetError

__all__ = ["EvalMetric", "CompositeEvalMetric", "Accuracy", "TopKAccuracy",
           "F1", "MCC", "MAE", "MSE", "RMSE", "CrossEntropy", "NegativeLogLikelihood",
           "Perplexity", "PearsonCorrelation", "Loss", "Torch", "Caffe",
           "CustomMetric", "LatencySummary", "create", "register", "np_metric",
           # attached by the package init from metric_det (detection mAP)
           "VOCMApMetric", "VOC07MApMetric"]

_REGISTRY = {}


def register(klass):
    _REGISTRY[klass.__name__.lower()] = klass
    return klass


def _alias(name, klass):
    _REGISTRY[name.lower()] = klass


def create(metric, *args, **kwargs):
    """ref: mx.metric.create — name / callable / list / instance."""
    if callable(metric) and not isinstance(metric, type):
        return CustomMetric(metric, *args, **kwargs)
    if isinstance(metric, EvalMetric):
        return metric
    if isinstance(metric, (list, tuple)):
        composite = CompositeEvalMetric()
        for child in metric:
            composite.add(create(child, *args, **kwargs))
        return composite
    if isinstance(metric, str):
        if metric.lower() not in _REGISTRY:
            raise MXNetError(f"unknown metric {metric!r}; known: "
                             f"{sorted(_REGISTRY)}")
        return _REGISTRY[metric.lower()](*args, **kwargs)
    if isinstance(metric, type) and issubclass(metric, EvalMetric):
        return metric(*args, **kwargs)
    raise MXNetError(f"cannot create metric from {metric!r}")


def _to_numpy(x):
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype in (torch.bfloat16, torch.float16):
            x = x.float()
        return x.cpu().numpy()
    if hasattr(x, "asnumpy"):
        return x.asnumpy()
    return np.asarray(x)


def _as_list(x):
    return x if isinstance(x, (list, tuple)) else [x]


class EvalMetric:
    """Base metric (ref: metric.py EvalMetric)."""

    def __init__(self, name, output_names=None, label_names=None, **kwargs):
        self.name = str(name)
        self.output_names = output_names
        self.label_names = label_names
        self._kwargs = kwargs
        self.reset()

    def __str__(self):
        return f"EvalMetric: {dict(zip(*self.get()))}"

    def update(self, labels, preds):
        raise NotImplementedError

    def update_dict(self, label, pred):
        if self.output_names is not None:
            pred = [pred[name] for name in self.output_names if name in pred]
        else:
            pred = list(pred.values())
        if self.label_names is not None:
            label = [label[name] for name in self.label_names if name in label]
        else:
            label = list(label.values())
        self.update(label, pred)

    def reset(self):
        self.num_inst = 0
        self.sum_metric = 0.0

    def get(self):
        if self.num_inst == 0:
            return (self.name, float("nan"))
        return (self.name, self.sum_metric / self.num_inst)

    def get_name_value(self):
        name, value = self.get()
        if not isinstance(name, list):
            name = [name]
        if not isinstance(value, list):
            value = [value]
        return list(zip(name, value))


class CompositeEvalMetric(EvalMetric):
    """ref: metric.py CompositeEvalMetric."""

    def __init__(self, metrics=None, name="composite", output_names=None,
                 label_names=None):
        super().__init__(name, output_names, label_names)
        self.metrics = [create(m) for m in (metrics or [])]

    def add(self, metric):
        self.metrics.append(create(metric))

    def get_metric(self, index):
        return self.metrics[index]

    def update(self, labels, preds):
        for metric in self.metrics:
            metric.update(labels, preds)

    def reset(self):
        for metric in getattr(self, "metrics", []):
            metric.reset()

    def get(self):
        names, values = [], []
        for metric in self.metrics:
            name, value = metric.get()
            names.extend(_as_list(name))
            values.extend(_as_list(value))
        return (names, values)


@register
class Accuracy(EvalMetric):
    """ref: metric.py Accuracy."""

    def __init__(self, axis=1, name="accuracy", output_names=None,
                 label_names=None):
        super().__init__(name, output_names, label_names)
        self.axis = axis

    def update(self, labels, preds):
        for label, pred in zip(_as_list(labels), _as_list(preds)):
            pred = _to_numpy(pred)
            label = _to_numpy(label)
            if pred.ndim > label.ndim:
                pred = np.argmax(pred, axis=self.axis)
            pred = pred.astype(np.int64).ravel()
            label = label.astype(np.int64).ravel()
            self.sum_metric += int((pred == label).sum())
            self.num_inst += len(label)


@register
class TopKAccuracy(EvalMetric):
    """ref: metric.py TopKAccuracy."""

    def __init__(self, top_k=1, name="top_k_accuracy", output_names=None,
                 label_names=None):
        super().__init__(f"{name}_{top_k}", output_names, label_names)
        self.top_k = top_k

    def update(self, labels, preds):
        for label, pred in zip(_as_list(labels), _as_list(preds)):
            pred = _to_numpy(pred)
            label = _to_numpy(label).astype(np.int64).ravel()
            top = np.argpartition(pred, -self.top_k, axis=-1)[..., -self.top_k:]
            top = top.reshape(len(label), -1)
            self.sum_metric += int((top == label[:, None]).any(axis=1).sum())
            self.num_inst += len(label)


@register
class F1(EvalMetric):
    """Binary F1 (ref: metric.py F1)."""

    def __init__(self, name="f1", output_names=None, label_names=None,
                 average="macro"):
        self.average = average
        super().__init__(name, output_names, label_names)

    def reset(self):
        super().reset()
        self._tp = self._fp = self._fn = 0

    def update(self, labels, preds):
        for label, pred in zip(_as_list(labels), _as_list(preds)):
            pred = _to_numpy(pred)
            label = _to_numpy(label).ravel().astype(np.int64)
            if pred.ndim > 1 and pred.shape[-1] > 1:
                pred = np.argmax(pred, axis=-1)
            else:
                pred = (pred.ravel() > 0.5).astype(np.int64)
            pred = pred.ravel()
            self._tp += int(((pred == 1) & (label == 1)).sum())
            self._fp += int(((pred == 1) & (label == 0)).sum())
            self._fn += int(((pred == 0) & (label == 1)).sum())
            self.num_inst += len(label)

    def get(self):
        precision = self._tp / max(self._tp + self._fp, 1)
        recall = self._tp / max(self._tp + self._fn, 1)
        f1 = 2 * precision * recall / max(precision + recall, 1e-12)
        return (self.name, f1 if self.num_inst else float("nan"))


@register
class MCC(EvalMetric):
    """Matthews correlation coefficient (ref: metric.py MCC)."""

    def __init__(self, name="mcc", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    def reset(self):
        super().reset()
        self._tp = self._fp = self._tn = self._fn = 0

    def update(self, labels, preds):
        for label, pred in zip(_as_list(labels), _as_list(preds)):
            pred = _to_numpy(pred)
            label = _to_numpy(label).ravel().astype(np.int64)
            if pred.ndim > 1 and pred.shape[-1] > 1:
                pred = np.argmax(pred, axis=-1)
            else:
                pred = (pred.ravel() > 0.5).astype(np.int64)
            pred = pred.ravel()
            self._tp += int(((pred == 1) & (label == 1)).sum())
            self._fp += int(((pred == 1) & (label == 0)).sum())
            self._tn += int(((pred == 0) & (label == 0)).sum())
            self._fn += int(((pred == 0) & (label == 1)).sum())
            self.num_inst += len(label)

    def get(self):
        tp, fp, tn, fn = self._tp, self._fp, self._tn, self._fn
        denom = np.sqrt(float((tp + fp) * (tp + fn) * (tn + fp) * (tn + fn)))
        mcc = (tp * tn - fp * fn) / denom if denom else 0.0
        return (self.name, mcc if self.num_inst else float("nan"))


@register
class MAE(EvalMetric):
    """ref: metric.py MAE."""

    def __init__(self, name="mae", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    def update(self, labels, preds):
        for label, pred in zip(_as_list(labels), _as_list(preds)):
            label = _to_numpy(label)
            pred = _to_numpy(pred).reshape(label.shape)
            self.sum_metric += float(np.abs(label - pred).mean())
            self.num_inst += 1


@register
class MSE(EvalMetric):
    """ref: metric.py MSE."""

    def __init__(self, name="mse", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    def update(self, labels, preds):
        for label, pred in zip(_as_list(labels), _as_list(preds)):
            label = _to_numpy(label)
            pred = _to_numpy(pred).reshape(label.shape)
            self.sum_metric += float(((label - pred) ** 2).mean())
            self.num_inst += 1


@register
class RMSE(MSE):
    """ref: metric.py RMSE."""

    def __init__(self, name="rmse", output_names=None, label_names=None):
        EvalMetric.__init__(self, name, output_names, label_names)

    def get(self):
        if self.num_inst == 0:
            return (self.name, float("nan"))
        return (self.name, float(np.sqrt(self.sum_metric / self.num_inst)))


@register
class CrossEntropy(EvalMetric):
    """ref: metric.py CrossEntropy — pred rows are probabilities."""

    def __init__(self, eps=1e-12, name="cross-entropy", output_names=None,
                 label_names=None):
        super().__init__(name, output_names, label_names)
        self.eps = eps

    def update(self, labels, preds):
        for label, pred in zip(_as_list(labels), _as_list(preds)):
            label = _to_numpy(label).ravel().astype(np.int64)
            pred = _to_numpy(pred).reshape(len(label), -1)
            prob = pred[np.arange(len(label)), label]
            self.sum_metric += float(-np.log(prob + self.eps).sum())
            self.num_inst += len(label)


@register
class NegativeLogLikelihood(CrossEntropy):
    """ref: metric.py NegativeLogLikelihood."""

    def __init__(self, eps=1e-12, name="nll-loss", output_names=None,
                 label_names=None):
        super().__init__(eps, name, output_names, label_names)


@register
class Perplexity(CrossEntropy):
    """ref: metric.py Perplexity."""

    def __init__(self, ignore_label=None, axis=-1, name="perplexity",
                 output_names=None, label_names=None):
        super().__init__(name=name, output_names=output_names,
                         label_names=label_names)
        self.ignore_label = ignore_label

    def update(self, labels, preds):
        for label, pred in zip(_as_list(labels), _as_list(preds)):
            label = _to_numpy(label).ravel().astype(np.int64)
            pred = _to_numpy(pred).reshape(len(label), -1)
            prob = pred[np.arange(len(label)), label]
            if self.ignore_label is not None:
                keep = label != self.ignore_label
                prob = prob[keep]
            self.sum_metric += float(-np.log(prob + self.eps).sum())
            self.num_inst += len(prob)

    def get(self):
        if self.num_inst == 0:
            return (self.name, float("nan"))
        return (self.name, float(np.exp(self.sum_metric / self.num_inst)))


@register
class PearsonCorrelation(EvalMetric):
    """ref: metric.py PearsonCorrelation."""

    def __init__(self, name="pearsonr", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    def reset(self):
        super().reset()
        self._labels, self._preds = [], []

    def update(self, labels, preds):
        for label, pred in zip(_as_list(labels), _as_list(preds)):
            self._labels.append(_to_numpy(label).ravel())
            self._preds.append(_to_numpy(pred).ravel())
            self.num_inst += 1

    def get(self):
        if not self._labels:
            return (self.name, float("nan"))
        label = np.concatenate(self._labels)
        pred = np.concatenate(self._preds)
        return (self.name, float(np.corrcoef(label, pred)[0, 1]))


@register
class Loss(EvalMetric):
    """Mean of raw loss outputs (ref: metric.py Loss)."""

    def __init__(self, name="loss", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    def update(self, _, preds):
        for pred in _as_list(preds):
            loss = _to_numpy(pred)
            self.sum_metric += float(loss.sum())
            self.num_inst += loss.size


class Torch(Loss):
    """ref: metric.py Torch (alias of Loss)."""

    def __init__(self, name="torch", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)


class Caffe(Loss):
    """ref: metric.py Caffe (alias of Loss)."""

    def __init__(self, name="caffe", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)


@register
class CustomMetric(EvalMetric):
    """Wrap feval(label, pred) (ref: metric.py CustomMetric)."""

    def __init__(self, feval, name=None, allow_extra_outputs=False,
                 output_names=None, label_names=None):
        name = name or getattr(feval, "__name__", "custom")
        super().__init__(f"custom({name})", output_names, label_names)
        self._feval = feval
        self._allow_extra_outputs = allow_extra_outputs

    def update(self, labels, preds):
        for label, pred in zip(_as_list(labels), _as_list(preds)):
            value = self._feval(_to_numpy(label), _to_numpy(pred))
            if isinstance(value, tuple):
                sum_metric, num_inst = value
                self.sum_metric += sum_metric
                self.num_inst += num_inst
            else:
                self.sum_metric += value
                self.num_inst += 1


def np_metric(numpy_feval=None, name=None, allow_extra_outputs=False):
    """Decorator form (ref: metric.py np)."""
    def deco(feval):
        def factory():
            return CustomMetric(feval, name or feval.__name__,
                                allow_extra_outputs)
        return factory
    if numpy_feval is not None:
        return deco(numpy_feval)
    return deco


# LatencySummary moved to observability.metrics (the metrics registry's
# histogram backend — docs/observability.md); re-exported here for
# compatibility with every existing consumer (serving, bench, tests).
from .observability.metrics import LatencySummary  # noqa: E402


_alias("ce", CrossEntropy)
_alias("nll_loss", NegativeLogLikelihood)
_alias("acc", Accuracy)
_alias("top_k_acc", TopKAccuracy)
_alias("top_k_accuracy", TopKAccuracy)
_alias("pearson_correlation", PearsonCorrelation)
