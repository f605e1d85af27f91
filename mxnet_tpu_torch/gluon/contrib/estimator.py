"""``gluon.contrib.estimator`` — the fit API (counterpart of
``mxnet_tpu/gluon/contrib/estimator.py``): ``Estimator(net, loss,
train_metrics, trainer).fit(train_data, val_data, epochs)`` with the
reference's six event points (TrainBegin, EpochBegin, BatchBegin,
BatchEnd, EpochEnd, TrainEnd) and its logging, checkpoint and
early-stopping handlers.

``train_data`` and ``val_data`` are any iterables of ``(data, label)``
batches (``gluon.data`` is ROADMAP Queue 1 item 11); one with a
``reset()`` is reset before each pass, as the JAX package resets its
iterators. A step is ``autograd.record`` → loss → ``autograd.backward``
→ ``Trainer.step``, as every other training loop of the port.
"""
from __future__ import annotations

import copy
import logging
import math
import os
import time

import torch

from ... import autograd as _autograd
from ... import metric as _metric
from ...base import MXNetError
from .. import loss as gloss
from ..trainer import Trainer
from ..utils import split_and_load  # noqa: F401  (the reference re-exports)

__all__ = ["Estimator", "TrainBegin", "TrainEnd", "EpochBegin",
           "EpochEnd", "BatchBegin", "BatchEnd", "LoggingHandler",
           "CheckpointHandler", "EarlyStoppingHandler", "StopTraining"]


class StopTraining(Exception):
    """Raised by a handler to stop fit() (ref: event_handler.py)."""


class TrainBegin:
    def train_begin(self, estimator, *args, **kwargs):
        pass


class TrainEnd:
    def train_end(self, estimator, *args, **kwargs):
        pass


class EpochBegin:
    def epoch_begin(self, estimator, *args, **kwargs):
        pass


class EpochEnd:
    def epoch_end(self, estimator, *args, **kwargs):
        pass


class BatchBegin:
    def batch_begin(self, estimator, *args, **kwargs):
        pass


class BatchEnd:
    def batch_end(self, estimator, *args, **kwargs):
        pass


def _metrics_text(metrics, prefix=""):
    return " ".join(f"{prefix}{n}={v:.4f}" for n, v in
                    (m.get() for m in metrics))


class LoggingHandler(TrainBegin, BatchEnd, EpochEnd, TrainEnd):
    """Periodic metric logging (ref: event_handler.py LoggingHandler)."""

    def __init__(self, log_interval=50):
        self.log_interval = log_interval
        self._batches = 0
        self._tic = None

    def train_begin(self, estimator, *args, **kwargs):
        self._tic = time.monotonic()
        logging.info("Training begin")

    def batch_end(self, estimator, *args, **kwargs):
        self._batches += 1
        if self.log_interval and self._batches % self.log_interval == 0:
            logging.info("[batch %d] %s", self._batches,
                         _metrics_text(estimator.train_metrics))

    def epoch_end(self, estimator, epoch=None, **kwargs):
        logging.info("Epoch[%s] %s %s", epoch,
                     _metrics_text(estimator.train_metrics),
                     _metrics_text(estimator.val_metrics, "val_"))

    def train_end(self, estimator, *args, **kwargs):
        logging.info("Training end (%.1fs)", time.monotonic() - self._tic)


class CheckpointHandler(EpochEnd, TrainEnd):
    """Save the parameters (``save_parameters``' ``.params``) after each
    epoch as ``{prefix}-epoch{N}.params``, the best by ``monitor`` as
    ``-best.params`` with ``save_best``, and ``-final.params`` at the end
    (ref: event_handler.py CheckpointHandler)."""

    def __init__(self, model_dir, model_prefix="model", monitor=None,
                 mode="min", save_best=False):
        os.makedirs(model_dir, exist_ok=True)
        self.prefix = os.path.join(model_dir, model_prefix)
        self.monitor = monitor
        self.save_best = save_best
        if mode not in ("min", "max"):
            raise MXNetError(f"mode must be min/max, got {mode!r}")
        self._sign = 1.0 if mode == "min" else -1.0
        self._best = None

    def epoch_end(self, estimator, epoch=None, **kwargs):
        estimator.net.save_parameters(f"{self.prefix}-epoch{epoch}.params")
        if self.save_best and self.monitor is not None:
            _, value = self.monitor.get()
            score = self._sign * value
            if self._best is None or score < self._best:
                self._best = score
                estimator.net.save_parameters(f"{self.prefix}-best.params")

    def train_end(self, estimator, *args, **kwargs):
        estimator.net.save_parameters(f"{self.prefix}-final.params")


class EarlyStoppingHandler(EpochEnd):
    """Stop when ``monitor`` has not improved by ``min_delta`` for more
    than ``patience`` epochs (ref: event_handler.py
    EarlyStoppingHandler); a NaN monitor (never updated) is skipped."""

    def __init__(self, monitor, mode="min", patience=3, min_delta=0.0):
        self.monitor = monitor
        self.patience = patience
        self.min_delta = min_delta
        self._sign = 1.0 if mode == "min" else -1.0
        self._best = None
        self._bad = 0

    def epoch_end(self, estimator, epoch=None, **kwargs):
        name, value = self.monitor.get()
        if isinstance(value, float) and math.isnan(value):
            logging.warning("EarlyStoppingHandler: monitor %r is NaN "
                            "(was it ever updated?); skipping", name)
            return
        score = self._sign * value
        if self._best is None or score < self._best - self.min_delta:
            self._best = score
            self._bad = 0
        else:
            self._bad += 1
            if self._bad > self.patience:
                raise StopTraining(
                    f"{name} stopped improving for {self._bad} epochs")


def _as_metrics(metrics):
    if metrics is None:
        return []
    if isinstance(metrics, _metric.EvalMetric):
        metrics = [metrics]
    return list(metrics)


def _unpack(batch):
    """``(data, label)`` of a batch: a pair, or a DataBatch-like object
    with ``data[0]`` and ``label[0]``."""
    if hasattr(batch, "data") and hasattr(batch, "label"):
        return batch.data[0], batch.label[0]
    data, label = batch
    return data, label


def _reset(data):
    if hasattr(data, "reset"):
        data.reset()


class Estimator:
    """The train loop (ref: estimator.py Estimator): per batch, record →
    loss → backward → ``Trainer.step(batch size)``, the train metrics
    updated; handlers observe the reference's event points. Without a
    ``trainer``, Adam at lr 1e-3 over ``net.collect_params()``."""

    def __init__(self, net, loss, train_metrics=None, trainer=None,
                 val_metrics=None, val_loss=None):
        self.net = net
        if not isinstance(loss, gloss.Loss):
            raise MXNetError("loss must be a gluon Loss")
        self.loss = loss
        self.val_loss = val_loss or loss
        self.train_metrics = _as_metrics(train_metrics) or \
            [_metric.Accuracy()]
        self.val_metrics = _as_metrics(val_metrics) or \
            [copy.deepcopy(m) for m in self.train_metrics]
        for m in self.val_metrics:
            m.reset()
        # the validation loss is a metric of its own, fed by evaluate()
        self._val_loss_metric = _metric.Loss(name="loss")
        self.val_metrics.append(self._val_loss_metric)
        self.trainer = trainer or Trainer(
            net.collect_params(), "adam", {"learning_rate": 1e-3})

    def _call(self, handlers, event, *args, **kwargs):
        for h in handlers:
            fn = getattr(h, event, None)
            if fn is not None:
                fn(self, *args, **kwargs)

    def _batch(self, batch):
        data, label = _unpack(batch)
        with _autograd.record():
            out = self.net(data)
            loss = self.loss(out, label)
        _autograd.backward(loss)
        self.trainer.step(data.shape[0])
        for m in self.train_metrics:
            m.update([label], [out])
        return loss

    def evaluate(self, val_data, metrics=None):
        """ref: estimator.py evaluate — run ``val_data`` through the net
        and update ``metrics`` (default: the validation metrics and the
        validation loss); returns each metric's ``get()``."""
        metrics = _as_metrics(metrics) or self.val_metrics
        for m in metrics:
            m.reset()
        _reset(val_data)
        for batch in val_data:
            data, label = _unpack(batch)
            with torch.no_grad():
                out = self.net(data)
                loss = self.val_loss(out, label)
            for m in metrics:
                if m is self._val_loss_metric:
                    m.update(None, [loss])
                else:
                    m.update([label], [out])
        return [m.get() for m in metrics]

    def fit(self, train_data, val_data=None, epochs=1, event_handlers=None,
            batches=None):
        """ref: estimator.py fit(train_data, val_data, epochs);
        ``batches`` caps the steps of an epoch. Every handler's
        ``epoch_end`` runs in the epoch a handler stops, then fit ends."""
        handlers = list(event_handlers or [])
        if not any(isinstance(h, LoggingHandler) for h in handlers):
            handlers.append(LoggingHandler())
        self._call(handlers, "train_begin")
        try:
            for epoch in range(epochs):
                for m in self.train_metrics:
                    m.reset()
                _reset(train_data)
                self._call(handlers, "epoch_begin", epoch=epoch)
                for i, batch in enumerate(train_data):
                    if batches is not None and i >= batches:
                        break
                    self._call(handlers, "batch_begin", batch=batch)
                    loss = self._batch(batch)
                    self._call(handlers, "batch_end", batch=batch,
                               loss=loss)
                if val_data is not None:
                    self.evaluate(val_data)
                stop = None
                for h in handlers:
                    fn = getattr(h, "epoch_end", None)
                    if fn is None:
                        continue
                    try:
                        fn(self, epoch=epoch)
                    except StopTraining as e:
                        stop = e
                if stop is not None:
                    raise stop
        except StopTraining as e:
            logging.info("Stop training: %s", e)
        self._call(handlers, "train_end")
        return self
