"""Training callbacks (counterpart of ``mxnet_tpu/callback.py``; ref:
python/mxnet/callback.py). ``do_checkpoint`` writes epoch checkpoints
through ``model.save_checkpoint``."""
from __future__ import annotations

import logging
import time

__all__ = ["Speedometer", "do_checkpoint", "log_train_metric",
           "LogValidationMetricsCallback", "module_checkpoint"]


class Speedometer:
    """Logs samples/sec every ``frequent`` batches (ref: callback.py
    Speedometer)."""

    def __init__(self, batch_size, frequent=50, auto_reset=True):
        self.batch_size = batch_size
        self.frequent = frequent
        self.auto_reset = auto_reset
        self.init = False
        self.tic = 0
        self.last_count = 0

    def __call__(self, param):
        count = param.nbatch
        if self.last_count > count:
            self.init = False
        self.last_count = count
        if self.init:
            if count % self.frequent == 0:
                speed = self.frequent * self.batch_size / \
                    (time.monotonic() - self.tic)
                if param.eval_metric is not None:
                    name_value = param.eval_metric.get_name_value()
                    if self.auto_reset:
                        param.eval_metric.reset()
                    msg = "Epoch[%d] Batch [%d]\tSpeed: %.2f samples/sec"
                    msg += "\t%s=%f" * len(name_value)
                    logging.info(msg, param.epoch, count, speed,
                                 *sum(name_value, ()))
                else:
                    logging.info(
                        "Iter[%d] Batch [%d]\tSpeed: %.2f samples/sec",
                        param.epoch, count, speed)
                self.tic = time.monotonic()
        else:
            self.init = True
            self.tic = time.monotonic()


def do_checkpoint(prefix, period=1, keep_last=None):
    """Epoch-end checkpointing callback (ref: callback.py do_checkpoint):
    ``callback(epoch, symbol, arg_params, aux_params)`` saves epoch
    ``epoch + 1`` every ``period`` epochs through the atomic path (a
    preemption mid-save leaves the previous epoch intact), creating the
    prefix's directory if missing; ``keep_last=k`` then keeps the newest
    k epochs."""
    from . import model
    period = int(max(1, period))

    def _callback(iter_no, sym, arg, aux):
        if (iter_no + 1) % period == 0:
            model.save_checkpoint(prefix, iter_no + 1, sym, arg, aux)
            if keep_last:
                model.gc_checkpoints(prefix, keep_last)
    return _callback


module_checkpoint = do_checkpoint


def log_train_metric(period, auto_reset=False):
    """ref: callback.py log_train_metric."""

    def _callback(param):
        if param.nbatch % period == 0 and param.eval_metric is not None:
            name_value = param.eval_metric.get_name_value()
            for name, value in name_value:
                logging.info("Iter[%d] Batch[%d] Train-%s=%f",
                             param.epoch, param.nbatch, name, value)
            if auto_reset:
                param.eval_metric.reset()
    return _callback


class LogValidationMetricsCallback:
    """ref: callback.py LogValidationMetricsCallback."""

    def __call__(self, param):
        if param.eval_metric is None:
            return
        for name, value in param.eval_metric.get_name_value():
            logging.info("Epoch[%d] Validation-%s=%f", param.epoch, name,
                         value)
